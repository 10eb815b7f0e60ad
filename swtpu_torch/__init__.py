"""swtpu_torch: Smith-Waterman protein database search in PyTorch and CUDA.

The PyTorch/H100 port of ``swtpu``: one query against a database packed on
the card, scored by a hand-written CUDA wavefront kernel, exact int32.  It
imports neither JAX nor ``swtpu``.
"""

__version__ = "0.1.0"
