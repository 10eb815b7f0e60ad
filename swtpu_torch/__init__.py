"""swtpu_torch: Smith-Waterman protein database search in PyTorch and CUDA.

The PyTorch/H100 port of ``swtpu``: queries against a database packed on the
card, scored by a hand-written CUDA wavefront kernel, exact int32, under
linear or affine gaps, with the top hits' alignments traced back on the
host.  It imports neither JAX nor ``swtpu``.
"""

from .config import REFERENCE_PARITY, SWConfig  # noqa: F401

__version__ = "0.1.0"
