"""uint32 hashing / permutation primitives shared by the samplers.

Port of zdr_tpu/samplers/hashes.py. torch on the CPU has no add, shift or
compare for torch.uint32, so a uint32 value here is an int64 tensor holding
[0, 2**32), and every operation masks back to 32 bits. 32x32-bit products
are split into 16-bit halves so that no int64 product overflows.

On the card these draws run inside the path-loop kernel with native
uint32_t arithmetic (kernels/csrc/path_loop_step.cuh); these functions are
its plain version, and the tests hold them bit for bit against the JAX
package.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPSILON = float.fromhex("0x1.fffffep-1")


def u32(x):
    """An integer tensor (or int) -> its uint32 bit pattern, as an int64
    tensor (or int) in [0, 2**32)."""
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def to_i32(u: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same bit pattern."""
    return (u - ((u >> 31) << 32)).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for a in [0, 2**32) and b a tensor or int of the same
    range, without an int64 product past 2**48."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    return (a * b_lo + (((a * b_hi) & 0xFFFF) << 16)) & M32


def _rotl(h: torch.Tensor, r: int) -> torch.Tensor:
    return ((h << r) | (h >> (32 - r))) & M32


def to_f32(u: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 value cast (round to nearest even)."""
    return u.to(torch.float32)


def xxhash32_4(x, y, z, w) -> torch.Tensor:
    """xxhash32 of four 32-bit words, elementwise (hashes.py:38)."""
    p2, p3, p4, p5 = 2246822519, 3266489917, 668265263, 374761393
    x, y, z, w = u32(x), u32(y), u32(z), u32(w)
    h = (w + p5 + mul32(x, p3)) & M32
    h = mul32(_rotl(h, 17), p4)
    h = (h + mul32(y, p3)) & M32
    h = mul32(_rotl(h, 17), p4)
    h = (h + mul32(z, p3)) & M32
    h = mul32(_rotl(h, 17), p4)
    h = mul32(h ^ (h >> 15), p2)
    h = mul32(h ^ (h >> 13), p3)
    return h ^ (h >> 16)


def _permute_round(i: torch.Tensor, w, p: torch.Tensor) -> torch.Tensor:
    """One round of the Kensler in-place permutation network."""
    i = i ^ p
    i = mul32(i, 0xE170893D)
    i = i ^ (p >> 16)
    i = i ^ ((i & w) >> 4)
    i = i ^ (p >> 8)
    i = mul32(i, 0x0929EB3F)
    i = i ^ (p >> 23)
    i = i ^ ((i & w) >> 1)
    i = mul32(i, 1 | (p >> 27))
    i = mul32(i, 0x6935FA69)
    i = i ^ ((i & w) >> 11)
    i = mul32(i, 0x74DCB303)
    i = i ^ ((i & w) >> 2)
    i = mul32(i, 0x9E501CC3)
    i = i ^ ((i & w) >> 2)
    i = mul32(i, 0xC860A3DF)
    i = i & w
    i = i ^ (i >> 5)
    return i


def permutation_rounds(i: torch.Tensor, l, w: int, p: torch.Tensor):
    """Kensler permutation of i within a list of length l (hashes.py:79):
    the first round, then another round for each lane whose candidate is
    still >= l, then (cand + p) % l. w is the next power of two above l,
    less 1, and l an int or a tensor like i -> (the element, the rounds past
    the first that each lane ran).

    A round maps [0, w] into itself, so if none of a lane's first w + 1
    candidates is below l, they repeat one and the lane cycles above l: the
    JAX package's loop never ends there. This happens only to corrmj's row
    stratum of an index past its grid (y >= res, at a spp that is no square
    and whose grid side is no power of two). The loop stops at w + 1
    candidates, which changes no lane that the JAX loop finishes, and such a
    lane takes (cand + p) % l of its last candidate."""
    p = u32(p)
    cand = _permute_round(u32(i), w, p)
    over = cand >= l
    rounds = torch.zeros_like(cand)
    for _ in range(w):
        if not bool(over.any()):
            break
        rounds += over
        cand = torch.where(over, _permute_round(cand, w, p), cand)
        over = cand >= l
    return ((cand + p) & M32) % l, rounds


def permutation_element(i: torch.Tensor, l, w: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler permutation of i within a list of length l: permutation_rounds'
    element."""
    return permutation_rounds(i, l, w, p)[0]


def permutation_element_pow2(i: torch.Tensor, w: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler permutation of i within a power-of-two list of length w + 1
    (hashes.py:110): the first-round candidate is always in range."""
    cand = _permute_round(u32(i), w, u32(p))
    return (cand + u32(p)) & w


def lcg_step(state: torch.Tensor) -> torch.Tensor:
    return (mul32(u32(state), 1664525) + 1013904223) & M32


def _finalize(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche (hashes.py:127)."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def lcg_to_unit_float(state: torch.Tensor) -> torch.Tensor:
    """LCG state -> [0, 1) through the finalizer and the top 24 bits."""
    return to_f32(_finalize(state) >> 8) * (1.0 / 0x01000000)


def is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def next_pow2_mask(spp: int) -> int:
    """w = next_pow2(spp) - 1."""
    w = spp - 1
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16
    return w
