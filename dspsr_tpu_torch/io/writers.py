"""Search-mode file writers.

The SIGPROC filterbank writer and the search-mode PSRFITS writer are the
JAX package's own, which are JAX-free and take numpy bytes; the port
re-exports them, as ``io.sources`` re-exports the readers.
"""

from dspsr_tpu.io.psrfits import PsrfitsSearchWriter  # noqa: F401
from dspsr_tpu.io.sigproc import (  # noqa: F401  (re-exported)
    SigProcWriter, observation_from_sigproc, read_sigproc_header)
