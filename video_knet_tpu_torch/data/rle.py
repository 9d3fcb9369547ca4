"""COCO run-length mask encoding in numpy.

Counterpart of `video_knet_tpu/data/rle.py`, which stands in for
pycocotools' `_mask` extension: column-major run lengths starting with a
run of zeros, and the COCO API's compressed string (each count after the
second stored as the difference to the count two before it, in 5-bit
groups with a continuation bit 0x20, offset by 48 into printable ASCII).
The counts and strings equal JAX's copy's.
"""

from __future__ import annotations

import numpy as np


def mask_to_counts(mask: np.ndarray) -> np.ndarray:
    """Binary [H, W] mask -> column-major run lengths (the first is of
    zeros; an empty mask is one run of 0, as in pycocotools)."""
    flat = np.asarray(mask, np.uint8).flatten(order="F")
    if flat.size == 0:
        return np.zeros((1,), np.int64)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    counts = np.diff(np.concatenate([[0], change, [flat.size]]))
    if flat[0] == 1:  # the first run is of zeros
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def counts_to_mask(counts: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    return np.repeat(vals, counts).reshape(tuple(hw), order="F")


def counts_to_string(counts: np.ndarray) -> str:
    """The COCO compressed RLE string of `counts`."""
    out = []
    cnts = [int(c) for c in counts]
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        while True:
            c = x & 0x1F
            x >>= 5  # arithmetic shift
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
            if not more:
                break
    return "".join(out)


def string_to_counts(s: str) -> np.ndarray:
    counts: list[int] = []
    i = 0
    while i < len(s):
        x = k = 0
        while True:
            c = ord(s[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            if not c & 0x20:
                if c & 0x10:  # sign-extend
                    x |= -1 << (5 * (k + 1))
                break
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def _counts_of(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode()
    return string_to_counts(counts) if isinstance(counts, str) else np.asarray(counts)


def encode_mask(mask: np.ndarray) -> dict:
    """Binary [H, W] mask -> COCO RLE {'size': [H, W], 'counts': str}."""
    mask = np.asarray(mask)
    return {"size": [int(mask.shape[0]), int(mask.shape[1])],
            "counts": counts_to_string(mask_to_counts(mask))}


def decode_mask(rle: dict) -> np.ndarray:
    return counts_to_mask(_counts_of(rle), tuple(rle["size"]))


def rle_area(rle: dict) -> int:
    return int(np.sum(_counts_of(rle)[1::2]))
