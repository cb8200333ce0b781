"""I/O: data sources, format registry, writers.

Importing this package enrolls all built-in formats in the probe registry
that ``sources.open_source`` consults (the role of the reference's
File_registry.C static registrations).
"""

from . import sources  # noqa: F401  (registers DADA/Dummy)
from . import sigproc  # noqa: F401  (registers SIGPROC filterbank input)
from . import psrfits_in  # noqa: F401  (registers PSRFITS search input)
from . import vdif  # noqa: F401  (registers VDIF)
from . import mark5b  # noqa: F401  (registers Mark5B)
from . import guppi  # noqa: F401  (registers GUPPI RAW)
from .sources import open_source, Source, DADAFile, DummySource, MultiFile  # noqa: F401
