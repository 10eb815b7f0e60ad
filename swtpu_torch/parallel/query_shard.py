"""Query-band sharding (counterpart of ``swtpu.parallel.query_shard``).

Lane sharding scales throughput but not the latency of one long query
against a small database: its whole DP still runs on one device.  Here the
query's bands split across the mesh instead:

* device k owns a contiguous block of the query's 32-row bands (its slice
  of the profile), and every device holds the whole database, as lane tiles;
* the computation runs as a systolic pipeline: at step t device k scores
  lane tile ``t - k`` with the wavefront kernel's band-carry hand-off
  (``wave_sw.sw_wave(top_in=, return_carry=True)``, mode B1d), continuing
  from the bottom row that device k - 1 handed it, and hands its own bottom
  row (H, and F beside it under affine gaps) to device k + 1;
* every device holds the max over its own bands of each lane, and the score
  is the max over devices.

One host thread enqueues every step on each device's current stream, with
no sync between steps.  A carry goes on with ``.to(next, non_blocking=True)``:
torch orders a copy between two cards by CUDA events on both devices'
current streams, so device k + 1's launch waits for device k's carry and
nothing else.  On a mesh that names one card n times the hand-off is the
same tensor, overwritten in place by the next device's launch.

``query_sharded_scores`` is the u-space version on ``ops.row_sw``'s PyTorch
scorer, with the ``(u, bestu)`` row state as the carry.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import row_sw, wave_sw
from ..ops.profile import PAD_SUBJECT, make_profile
from .mesh import Mesh, on_device, replicate, replicate_tiles


def band_slices(profile: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """Device k's contiguous block of the profile's bands, on device k."""
    rows = profile.shape[0]
    if rows % (wave_sw.W * mesh.size):
        raise ValueError(f"profile rows {rows} must split into {mesh.size} whole blocks of {wave_sw.W}-row bands")
    step = rows // mesh.size
    return tuple(
        profile[k * step : (k + 1) * step].contiguous().to(dev, non_blocking=True) for k, dev in enumerate(mesh.devices)
    )


def wave_pipeline(
    bands: Sequence[torch.Tensor],
    tiles: Sequence[torch.Tensor],
    mesh: Mesh,
    *,
    gap: Optional[int] = None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
) -> torch.Tensor:
    """The systolic band pipeline over one bucket: ``bands[k]`` device k's
    (rows, 32) int8 profile block, ``tiles[k]`` the bucket's tile-major
    ``(n_tiles, L2, Bt)`` replica on device k (``mesh.replicate_tiles``).
    Returns the bucket's (B,) int32 scores, lane order, on the mesh's
    primary device."""
    n, n_tiles = mesh.size, len(tiles[0])
    gaps = dict(gap=gap, gap_open=gap_open, gap_extend=gap_extend)
    best: List[List[Optional[torch.Tensor]]] = [[None] * n_tiles for _ in range(n)]
    hand: List[Optional[torch.Tensor]] = [None] * n_tiles  # tile j's carry, on the device that takes it next
    for t in range(n_tiles + n - 1):
        for k in range(n):
            j = t - k
            if not 0 <= j < n_tiles:
                continue
            dev = mesh.devices[k]
            with on_device(dev):
                # Device 0 starts from no band above (H = 0, F = NEG);
                # every later device continues from its neighbour's carry.
                scores, carry = wave_sw.sw_wave(bands[k], tiles[k][j], hand[j], return_carry=True, **gaps)
                best[k][j] = scores
                hand[j] = carry.to(mesh.devices[k + 1], non_blocking=True) if k + 1 < n else None
    primary = mesh.primary
    per_tile = []
    for j in range(n_tiles):
        top = best[0][j].to(primary, non_blocking=True)
        for k in range(1, n):
            top = torch.maximum(top, best[k][j].to(primary, non_blocking=True))
        per_tile.append(top)
    return torch.cat(per_tile)


def make_wave_query_sharded_step(
    mesh: Mesh,
    *,
    n_bands_local: int,
    n_tiles: int,
    Bt: int,
    gap: Optional[int] = None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
):
    """The systolic query-band pipeline on the wavefront kernel (swtpu's
    ``make_wave_query_sharded_step``): ``step(profile, subjT)`` with profile
    (n * n_bands_local * 32, 32) int8 and subjT (L2, n_tiles * Bt) int8 on
    any device returns (n_tiles * Bt,) int32 scores on the mesh's primary
    device, bit-equal to one ``sw_wave`` over the whole profile.  Affine
    gaps (``gap_open``/``gap_extend``) hand the H and F planes on."""

    def step(profile: torch.Tensor, subjT: torch.Tensor) -> torch.Tensor:
        if profile.shape[0] != mesh.size * n_bands_local * wave_sw.W:
            raise ValueError(f"profile rows {profile.shape[0]} != {mesh.size} x {n_bands_local} bands")
        if subjT.shape[1] != n_tiles * Bt:
            raise ValueError(f"subjT lanes {subjT.shape[1]} != {n_tiles} tiles x {Bt}")
        return wave_pipeline(
            band_slices(profile, mesh), replicate_tiles(subjT, Bt, mesh), mesh,
            gap=gap, gap_open=gap_open, gap_extend=gap_extend,
        )

    return step


def wave_layout(subjects: np.ndarray) -> Tuple[np.ndarray, int]:
    """A (B, L) subject batch as a transposed bucket, swtpu's layout:
    (width + 32, bpad) with width + 32 on the chunk ladder, lanes padded to
    ``pick_lanes``; returns (subjT, Bt)."""
    B, L = subjects.shape
    w = wave_sw.W
    need = -(-(L + w) // 32) * 32
    while not wave_sw.has_lc(need):
        need += 32
    bt, bpad = wave_sw.pick_lanes(B)
    subjT = np.full((need, bpad), PAD_SUBJECT, dtype=np.int8)
    subjT[:L, :B] = np.asarray(subjects, np.int8).T
    return subjT, bt


def wave_query_sharded_scores(
    mesh: Mesh,
    query_idx: np.ndarray,
    subjects: np.ndarray,
    matrix: np.ndarray,
    *,
    gap: Optional[int] = None,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
) -> np.ndarray:
    """Score one (long) query against a (B, L) subject batch with its bands
    sharded across the mesh on the wavefront kernel.  Returns (B,) exact
    int32 scores; affine when ``gap_open`` is set."""
    B = subjects.shape[0]
    subjT, bt = wave_layout(subjects)
    prof = make_profile(query_idx, matrix, pad_rows_to=wave_sw.W * mesh.size)
    step = make_wave_query_sharded_step(
        mesh, n_bands_local=prof.shape[0] // (wave_sw.W * mesh.size), n_tiles=subjT.shape[1] // bt, Bt=bt,
        gap=gap, gap_open=gap_open, gap_extend=gap_extend,
    )
    primary = mesh.primary
    out = step(torch.from_numpy(prof).to(primary), torch.from_numpy(subjT).to(primary))
    return out[:B].cpu().numpy()


def query_sharded_scores(
    mesh: Mesh,
    query_idx: np.ndarray,
    subjects: np.ndarray,
    matrix: np.ndarray,
    *,
    gap: int,
    strip: int = 32,
    block_rows: Optional[int] = None,
) -> np.ndarray:
    """Score one (long) query against a (B, L) subject batch with the query
    rows sharded across the mesh, on the u-space scorer: device k owns
    query rows [k * r, (k + 1) * r) and hands each block's (u, bestu) to
    device k + 1.  Returns (B,) exact int32 scores."""
    n = mesh.size
    B, L = subjects.shape
    if block_rows is None:
        # Enough blocks to fill the pipeline, small enough to bound the state.
        block_rows = min(max(8, -(-B // max(2 * n, 4))), B)
    n_blocks = -(-B // block_rows)
    subj = np.full((n_blocks * block_rows, L), PAD_SUBJECT, dtype=np.int8)
    subj[:B] = subjects
    prof = make_profile(query_idx, matrix, pad_rows_to=strip * n)
    step = prof.shape[0] // n
    parts = [torch.from_numpy(np.ascontiguousarray(prof[k * step : (k + 1) * step])).to(d) for k, d in enumerate(mesh.devices)]
    blocks = [replicate(subj[j * block_rows : (j + 1) * block_rows], mesh) for j in range(n_blocks)]
    rebase = replicate(np.broadcast_to(np.arange(L, dtype=np.int32) * gap, (block_rows, L)), mesh)
    scores: List[Optional[torch.Tensor]] = [None] * n_blocks
    hand: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * n_blocks
    for t in range(n_blocks + n - 1):
        for k in range(n):
            j = t - k
            if not 0 <= j < n_blocks:
                continue
            dev = mesh.devices[k]
            with on_device(dev):
                u0, bu0 = (rebase[k], rebase[k]) if k == 0 else hand[j]
                u, bu = row_sw.sw_score_rows(parts[k], blocks[j][k], u0, bu0, gap=gap, strip=strip)
                if k + 1 < n:
                    nxt = mesh.devices[k + 1]
                    hand[j] = (u.to(nxt, non_blocking=True), bu.to(nxt, non_blocking=True))
                else:  # the last device completes the block
                    scores[j] = (bu - rebase[k]).amax(dim=1).to(torch.int32).to(mesh.primary)
    return torch.cat(scores)[:B].cpu().numpy()

