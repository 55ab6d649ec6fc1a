"""Version constants of the port.

Port of :mod:`spectra_tpu.util.version`: the port carries the JAX
package's version, whose public surface it mirrors.
"""

SPECTRA_TPU_MAJOR_VERSION = 0
SPECTRA_TPU_MINOR_VERSION = 4
SPECTRA_TPU_PATCH_VERSION = 0

__version__ = "{}.{}.{}".format(
    SPECTRA_TPU_MAJOR_VERSION, SPECTRA_TPU_MINOR_VERSION, SPECTRA_TPU_PATCH_VERSION
)
