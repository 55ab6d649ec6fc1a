"""The benchmark's plain reference: numpy and scipy only. It imports
nothing of ``jax``, ``spectra_tpu`` or ``spectra_tpu_torch``."""
