"""The benchmark of ``spectra_tpu_torch``: time to solution of
eigenproblems on one NVIDIA GPU. See ``README.md``."""
