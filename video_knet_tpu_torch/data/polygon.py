"""COCO polygon -> binary mask rasterization in numpy.

Counterpart of `video_knet_tpu/data/polygon.py`, the same arithmetic, so
every mask is bit-equal to JAX's. The reference rasterizes YT-VIS polygon
annotations with the pycocotools C extension (`frPyObjects` + `merge` +
`decode`); this is its polygon fill (`rleFrPoly`):

1. polygon vertices are scaled 5x and rounded with C's truncating
   `(int)(v + .5)`;
2. each edge is drawn densely along its major axis, from its lower end;
3. boundary crossings are downsampled back to pixel-grid x-columns, keeping
   only crossings that land exactly on a pixel-center column;
4. crossing positions (column-major linear indices) are sorted and turned
   into a run-length encoding by parity (even/odd fill).

The parts of one object are OR-merged (the COCO `merge` of a single
object's part list).
"""

from __future__ import annotations

import numpy as np

from video_knet_tpu_torch.data.rle import counts_to_mask


def _poly_to_counts(xy: np.ndarray, h: int, w: int) -> np.ndarray:
    """Single polygon (flat [x0, y0, x1, y1, ...]) -> column-major RLE counts."""
    scale = 5.0
    xy = np.asarray(xy, np.float64)
    k = xy.size // 2
    # (int)(scale * v + .5) in C truncates toward zero
    x = np.trunc(scale * xy[0::2] + 0.5).astype(np.int64)
    y = np.trunc(scale * xy[1::2] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    us: list[np.ndarray] = []
    vs: list[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe = xe, xs
            ys, ye = ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx > 0 else 0.0
            d = np.arange(dx + 1, dtype=np.int64)
            t = dx - d if flip else d
            u = t + xs
            v = np.trunc(ys + s * t + 0.5).astype(np.int64)
        else:
            s = (xe - xs) / dy if dy > 0 else 0.0
            d = np.arange(dy + 1, dtype=np.int64)
            t = dy - d if flip else d
            v = t + ys
            u = np.trunc(xs + s * t + 0.5).astype(np.int64)
        us.append(u)
        vs.append(v)
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # downsample the boundary crossings to pixel-grid columns
    du = u[1:] != u[:-1]
    uj, ujm1 = u[1:][du], u[:-1][du]
    vj, vjm1 = v[1:][du], v[:-1][du]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(vj, vjm1).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0.0, float(h)))
    xi = xd[keep].astype(np.int64)
    yi = yd[keep].astype(np.int64)

    # crossings -> RLE by parity; paired identical positions cancel out
    a = np.sort(np.append(xi * h + yi, h * w))
    a = np.diff(np.concatenate([[0], a]))
    b = [int(a[0])]
    j, n = 1, len(a)
    while j < n:
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < n:
                b[-1] += int(a[j])
                j += 1
    return np.asarray(b, np.int64)


def polygons_to_mask(polygons: list, h: int, w: int) -> np.ndarray:
    """COCO polygon list (one object, possibly several parts) -> [H, W] uint8.

    pycocotools' ``decode(merge(frPyObjects(polygons, h, w)))``. Degenerate
    parts (fewer than 3 vertices) are skipped, as mmdet's loaders do."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polygons:
        poly = np.asarray(poly, np.float64).reshape(-1)
        if poly.size < 6:
            continue
        mask |= counts_to_mask(_poly_to_counts(poly, h, w), (h, w))
    return mask
