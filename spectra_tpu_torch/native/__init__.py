"""Host (C++) code of the port: the native dense Krylov-Schur driver
(:mod:`spectra_tpu_torch.native.dense_eigs`)."""
