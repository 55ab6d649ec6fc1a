"""Hand-written CUDA kernels of the port, each beside its plain torch
version and its launch counter: ``dia_spmv`` (the DIA SpMV), ``dia_ds``
(the double-single hi/lo DIA SpMV), ``stream`` (the streaming bandwidth
probe), ``dia_variants`` (cost probes of the DIA SpMV) and ``tsqr`` (the
tall-skinny Householder QR of the Jacobi-Davidson blocks). See
:mod:`spectra_tpu_torch.ops._build` for how they are built."""
