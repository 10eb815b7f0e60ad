"""Protein residue alphabet and encoding (copy of ``swtpu.alphabet``).

25 letters in BLAST order, ``A R N D C Q E G H I L K M F P S T W Y V B J Z X *``.
Index 24 (``*``) is the catch-all: every byte that is not one of the 24 named
residues encodes to it.  Encoding a database is one table lookup over the raw
bytes.
"""

from __future__ import annotations

import numpy as np

ALPHABET = "ARNDCQEGHILKMFPSTWYVBJZX*"
ALPHABET_SIZE = len(ALPHABET)  # 25
STAR = ALPHABET.index("*")  # 24

# Profile tables have 32 columns; indices 25..31 are never produced by the
# encoder (25 is the subject pad, swtpu_torch.ops.profile.PAD_SUBJECT).
PADDED_ALPHABET_SIZE = 32

_ENCODE_TABLE = np.full(256, STAR, dtype=np.uint8)
for _i, _c in enumerate(ALPHABET):
    _ENCODE_TABLE[ord(_c)] = _i


def encode_bytes(data: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    """Encode raw residue bytes to int8 alphabet indices (vectorised)."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data.astype(np.uint8, copy=False)
    return _ENCODE_TABLE[arr].astype(np.int8)


def encode_str(seq: str) -> np.ndarray:
    """Encode a residue string to int8 alphabet indices."""
    return encode_bytes(seq.encode("ascii", errors="replace"))
