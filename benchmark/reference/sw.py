"""Plain Smith-Waterman scores, one query against many subjects.

Exact int32 dynamic programming in PyTorch, on any device, vectorised over
subjects: the subjects are sorted by length and laid in tiles of equal
width, and each query row is one pass over a tile.  Linear gaps (a gap of
length L costs L * gap) and Gotoh's affine gaps (``gap_open + (L - 1) *
gap_extend``) both close the row's left-to-right dependency with a prefix
maximum (``torch.cummax``):

    H[i, j] = max_{k <= j} (T[i, k] - gap * (j - k))               linear
    E[i, j] = max_{k <  j} (T[i, k] - open - extend * (j - 1 - k))  affine

where T holds the cell's other candidates (0, the diagonal plus the
substitution score, the vertical gap).  A subject's score is the largest H
of its cells.

``best_scores_many`` scores several queries, each against its own
subjects, in one pass: queries of similar lengths share a tile, a subject
row indexing its own query's substitution rows, and a shorter query's rows
padded with rows that score PAD_SCORE against everything.  A padded row's
H never exceeds the largest H of the row above it (its diagonal is below
zero, and its gaps only lose), so a padded row never raises a best.

``precision="int16"`` is the control of a lower precision: the same
recurrence with every H saturated at 32,767, as a saturating int16 kernel
keeps it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

PAD = 25  # the subject pad's column of the extended score rows
PAD_SCORE = -(1 << 20)  # below any diagonal a real cell can carry: a pad cell never raises a max
NEG = -(1 << 28)  # an unreachable vertical-gap score before the first row
INT16_MAX = 32767


def tiles(lengths: np.ndarray, ratio: float = 1.3, max_cells: int = 1 << 26) -> List[np.ndarray]:
    """Positions into ``lengths``, sorted by length and cut into tiles whose
    widest member is at most ``ratio`` times its narrowest and whose cells
    (members x width) stay under ``max_cells`` (one subject at least)."""
    order = np.argsort(lengths, kind="stable")
    out, start = [], 0
    while start < order.size:
        first = max(int(lengths[order[start]]), 1)
        end = start + 1
        while end < order.size:
            w = int(lengths[order[end]])
            if w > ratio * first or (end + 1 - start) * w > max_cells:
                break
            end += 1
        out.append(order[start:end])
        start = end
    return out


def _tile_subjects(residues: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(n, w) int32 residue indices of n subjects, PAD past each one's end."""
    w = max(int(lens.max()), 1)
    col = torch.arange(w, device=residues.device)
    idx = starts[:, None] + col[None, :]
    real = col[None, :] < lens[:, None]
    out = torch.where(real, residues[idx.clamp_(max=residues.numel() - 1)].to(torch.int32), PAD)
    return out.to(torch.int32)


def _rows(query: np.ndarray, matrix: np.ndarray, device) -> torch.Tensor:
    """(qlen, 26) int32: the substitution row of each query residue, and
    PAD_SCORE in the pad column."""
    ext = np.full((matrix.shape[0], PAD + 1), PAD_SCORE, dtype=np.int64)
    ext[:, : matrix.shape[1]] = matrix
    return torch.from_numpy(ext[np.asarray(query, dtype=np.int64)]).to(device=device, dtype=torch.int32)


def _tile_best(prof: torch.Tensor, subj: torch.Tensor, gaps: Dict[str, int], saturate: bool) -> torch.Tensor:
    """(n,) int32 best local score of each row of ``subj``: ``prof[i]`` holds
    row i's substitution scores, and ``subj`` indexes it (a subject's
    residue, offset by 26 times its query's place in ``prof``)."""
    n, w = subj.shape
    dev = subj.device
    flat = subj.reshape(-1)
    hb = torch.zeros(n, w + 1, dtype=torch.int32, device=dev)  # column 0 stays 0: H left of the subject
    best = torch.zeros(n, dtype=torch.int32, device=dev)
    sc = torch.empty(n * w, dtype=torch.int32, device=dev)
    t = torch.empty(n, w, dtype=torch.int32, device=dev)
    cv = torch.empty(n, w, dtype=torch.int32, device=dev)
    ci = torch.empty(n, w, dtype=torch.int64, device=dev)
    affine = "gap_open" in gaps
    if affine:
        op, ex = int(gaps["gap_open"]), int(gaps["gap_extend"])
        ramp = torch.arange(w, dtype=torch.int32, device=dev) * ex
        ramp_op = ramp[:-1] + op
        f = torch.full((n, w), NEG, dtype=torch.int32, device=dev)
        tmp = torch.empty(n, w, dtype=torch.int32, device=dev)
    else:
        g = int(gaps["gap"])
        ramp = torch.arange(w, dtype=torch.int32, device=dev) * g
    diag, up = hb[:, :-1], hb[:, 1:]
    for i in range(prof.shape[0]):
        torch.index_select(prof[i], 0, flat, out=sc)
        torch.add(diag, sc.view(n, w), out=t)
        if affine:
            f.sub_(ex)
            torch.sub(up, op, out=tmp)
            torch.maximum(f, tmp, out=f)
            torch.maximum(t, f, out=t)
            t.clamp_(min=0)
            torch.add(t, ramp, out=tmp)
            torch.cummax(tmp, 1, out=(cv, ci))
            # E[j] = cv[j - 1] - ramp[j - 1] - open; H = max(T, E)
            cv[:, :-1].sub_(ramp_op)
            torch.maximum(t[:, 1:], cv[:, :-1], out=up[:, 1:])
            up[:, 0] = t[:, 0]
        else:
            torch.sub(up, g, out=cv)
            torch.maximum(t, cv, out=t)
            t.clamp_(min=0).add_(ramp)
            torch.cummax(t, 1, out=(cv, ci))
            torch.sub(cv, ramp, out=up)
        if saturate:
            up.clamp_(max=INT16_MAX)
        torch.maximum(best, up.amax(dim=1), out=best)
    return best


def best_scores(
    query: np.ndarray,
    residues,
    offsets: np.ndarray,
    ids: np.ndarray,
    matrix: np.ndarray,
    gaps: Dict[str, int],
    device="cpu",
    precision: str = "int32",
    ratio: float = 1.3,
    max_cells: int = 1 << 26,
) -> np.ndarray:
    """int64 best local score of ``query`` against each subject ``ids[k]``
    of the database (``residues`` int8, as a host array or a tensor already
    on ``device``; sequence i is ``residues[offsets[i]:offsets[i + 1]]``),
    in the order of ``ids``.  ``gaps``: ``{"gap": g}`` or ``{"gap_open":
    o, "gap_extend": e}``."""
    return best_scores_many([query], [ids], residues, offsets, matrix, gaps, device, precision, ratio, max_cells)[0]


def best_scores_many(
    queries: List[np.ndarray],
    ids: List[np.ndarray],
    residues,
    offsets: np.ndarray,
    matrix: np.ndarray,
    gaps: Dict[str, int],
    device="cpu",
    precision: str = "int32",
    ratio: float = 1.3,
    max_cells: int = 1 << 26,
    query_ratio: float = 2.0,
) -> List[np.ndarray]:
    """``best_scores`` of each ``queries[g]`` against its own ``ids[g]``:
    queries whose longest is at most ``query_ratio`` times their shortest
    share each tile."""
    if precision not in ("int32", "int16"):
        raise ValueError(f"unknown precision {precision!r}")
    ids = [np.asarray(i, dtype=np.int64) for i in ids]
    out = [np.zeros(i.size, dtype=np.int64) for i in ids]
    live = sorted((g for g in range(len(queries)) if len(queries[g]) and ids[g].size), key=lambda g: len(queries[g]))
    if not live:
        return out
    res = residues if isinstance(residues, torch.Tensor) else torch.from_numpy(np.asarray(residues))
    res = res.to(device)
    offsets = np.asarray(offsets, dtype=np.int64)
    groups, start = [], 0
    for end in range(1, len(live) + 1):
        if end == len(live) or len(queries[live[end]]) > query_ratio * len(queries[live[start]]):
            groups.append(live[start:end])
            start = end
    for group in groups:
        rows = max(len(queries[g]) for g in group)
        prof = torch.full((rows, (PAD + 1) * len(group)), PAD_SCORE, dtype=torch.int32, device=device)
        for slot, g in enumerate(group):
            prof[: len(queries[g]), slot * (PAD + 1) : (slot + 1) * (PAD + 1)] = _rows(queries[g], matrix, device)
        owner = np.concatenate([np.full(ids[g].size, k, dtype=np.int64) for k, g in enumerate(group)])
        pos = np.concatenate([np.arange(ids[g].size) for g in group])
        pair = np.concatenate([ids[g] for g in group])
        lens = offsets[pair + 1] - offsets[pair]
        for part in tiles(lens, ratio, max_cells):
            part = part[lens[part] > 0]
            if part.size == 0:
                continue
            starts = torch.from_numpy(offsets[pair[part]]).to(device)
            subj = _tile_subjects(res, starts, torch.from_numpy(lens[part]).to(device))
            subj += torch.from_numpy(owner[part] * (PAD + 1)).to(device=device, dtype=torch.int32)[:, None]
            best = _tile_best(prof, subj, gaps, precision == "int16").cpu().numpy()
            for k, g in enumerate(group):
                mine = owner[part] == k
                out[g][pos[part][mine]] = best[mine]
    return out
