"""The benchmark's plain reference: what a search must answer, worked out
again from the benchmark's own arrays.

Plain PyTorch and NumPy only.  Nothing here imports the program under test
(``swtpu_torch``), its JAX original, or JAX: the scoring matrix, the
alphabet, the Smith-Waterman recurrences, the hit order, the E-value
arithmetic and the k-mer prefilter's heuristic are frozen copies of what
the configurations state.
"""
