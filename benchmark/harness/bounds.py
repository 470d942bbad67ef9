"""The least time an H100 needs for a kernel's work: operations and bytes
counted from the shapes and inputs that the reference records at the
cell's sizes (`refmodel.probe`), over the published peaks.

Frozen copy of the arithmetic of `chip_smoke.py`: the K6/K7 operation
counts (`sweep_phase`'s docstring), the K4 bytes (`resolve_bwd_phase`,
here of the kernel alone) and `visibility_bound` for K1 (its pairs
counted on the cull boxes). The `_ms` functions return milliseconds.
"""
from __future__ import annotations

from harness.peaks import (BF16_PEAK_FLOPS, F32_PEAK_FLOPS,
                           HBM_BYTES_PER_S)

NF = 256          # the netSDF trunk's width


def sweep_fwd_ops(N: int, d: int, L: int) -> int:
    """K6: 2·N·(d·256 + (L-1)·256² + 256) at the embedding's own width d
    (the kernel's zero padding is not work)."""
    return 2 * N * (d * NF + (L - 1) * NF * NF + NF)


def sweep_bwd_ops(N: int, d: int, L: int) -> int:
    """K7: the recomputed forward, every weight gradient and the
    cotangent's way back through the last and hidden layers: three times
    the forward less 2·N·d·256 (the input has no cotangent)."""
    return 3 * sweep_fwd_ops(N, d, L) - 2 * N * d * NF


def sweep_ms(ops: int, peak: float = BF16_PEAK_FLOPS) -> float:
    return ops / peak * 1e3


def resolve_bwd_ms(B: int, P: int, R: int, fg: int, rows: int,
                   g_bytes: int = 2) -> float:
    """K4 alone (its output's zeroing is a separate memset): the winner ids
    read once, the cotangent of the foreground pixels (in the compute
    type) read once, and each (image, face) row that a pixel won written
    once in float32; one float32 addition per foreground pixel and
    channel. The larger of the two. (`chip_smoke.py` timed the wrapper,
    memset included, and counted the whole (B, F, R) output.)"""
    nbytes = B * P * 4 + fg * R * g_bytes + rows * R * 4
    return max(nbytes / HBM_BYTES_PER_S * 1e3, fg * R / F32_PEAK_FLOPS * 1e3)


def visibility_ms(v_clip, faces, prep, resolution, visits, outputs) -> float:
    """K1 on these inputs: the larger of the bytes' and the operations'
    times (`visibility_work`)."""
    nbytes, pairs = visibility_work(v_clip, faces, prep, resolution, visits,
                                    outputs)
    return max(nbytes / HBM_BYTES_PER_S * 1e3,
               12 * pairs / F32_PEAK_FLOPS * 1e3)


def visibility_work(v_clip, faces, prep, resolution, visits,
                    outputs) -> tuple:
    """(bytes, live pairs) of the visibility function on these inputs.

    Operations: 12 float32 operations (3 edge functions) per live
    (face, pixel) pair, a pixel of a valid face's cull box (`prep`'s
    `fbox`, which bounds every pixel its edge tests can accept) in a live
    (tile, chunk) pair — one the occlusion skip keeps, as `visits` from
    the plain version records. (`chip_smoke.py` took the vertices'
    screen bbox, which a face with a vertex near the camera plane
    stretches far past what it can cover.) Bytes: the coefficients and
    original ids of the live sub-blocks, each read once, the tiles' chunk
    counts and z-mins, the list entries each tile walks, and the outputs
    written once."""
    import torch
    from refmodel.ops.rasterize_cuda import TILE_H, TILE_W
    height, width = resolution
    table, orig = prep["table"], prep["orig"].long()
    B, nch, _rows, chunk = table.shape
    sub = chunk // prep["nsub"]
    Fn = faces.shape[0]
    valid = (table[:, :, :7] != 0).any(2).reshape(B, -1) \
        & (orig < Fn)[None]                              # (B, Fp)
    b, t, cid, g = visits.unbind(1)
    slots = (cid * chunk + g * sub)[:, None] + torch.arange(
        sub, device=visits.device)                       # (n, sub)
    ntx = width // TILE_W
    bx = prep["fbox"].long()[b[:, None], slots]           # (n, sub, 4)
    tx0 = ((t % ntx) * TILE_W)[:, None]
    ty0 = ((t // ntx) * TILE_H)[:, None]
    nx = (torch.minimum(bx[..., 1], tx0 + TILE_W - 1)
          - torch.maximum(bx[..., 0], tx0) + 1).clamp(min=0)
    ny = (torch.minimum(bx[..., 3], ty0 + TILE_H - 1)
          - torch.maximum(bx[..., 2], ty0) + 1).clamp(min=0)
    bb = b[:, None]
    pairs = int((nx * ny * valid[bb, slots]).sum())
    live = torch.unique(visits[:, [0, 2, 3]], dim=0)      # (image, chunk, g)
    ids = torch.unique(live[:, 1:], dim=0)                # (chunk, g)
    walked = int(prep["counts"].sum())
    nbytes = (live.shape[0] * sub * 12 * 4 + ids.shape[0] * sub * 4
              + walked * 2 * 4
              + sum(prep[k].numel() * 4 for k in ("counts", "zlo"))
              + sum(a.numel() * a.element_size() for a in outputs))
    return nbytes, pairs


def from_records(records: list, g_bytes: int = 2) -> dict:
    """Bounds (ms) per launch by kernel, averaged over the recorded calls:
    {"k6": .., "k7": .., "k4": .., "k1": ..} where recorded."""
    acc = {}
    for kind, f in records:
        if kind == "sweep_fwd":
            acc.setdefault("k6", []).append(
                sweep_ms(sweep_fwd_ops(f["N"], f["d"], f["L"])))
        elif kind == "sweep_bwd":
            acc.setdefault("k7", []).append(
                sweep_ms(sweep_bwd_ops(f["N"], f["d"], f["L"])))
        elif kind == "resolve_bwd":
            acc.setdefault("k4", []).append(resolve_bwd_ms(
                f["B"], f["P"], f["R"], f["fg"], f["rows"], g_bytes))
        elif kind == "raster_ms":
            acc.setdefault("k1", []).append(f["ms"])
    return {k: sum(v) / len(v) for k, v in acc.items()}
