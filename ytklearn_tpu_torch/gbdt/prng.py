"""Threefry-2x32 keys and uniform draws, bit for bit those of `jax.random`.

The trainer and the engine draw the same random numbers as the JAX
package's (``ytklearn_tpu/gbdt/trainer.py:704-724,938,983`` and
``gbdt/engine.py:506-516``): the per-round key chain, the row and feature
sampling masks and GOSS's remainder draw. This module is their twin under
JAX's default `jax_threefry_partitionable = True`:

  PRNGKey(seed)       [0, seed & 0xFFFFFFFF] for a 32-bit seed
  split(key, n)       key i = threefry(key, (0, i))
  fold_in(key, data)  threefry(key, (0, data))
  uniform(key, shape) float32 in [0, 1): element i takes the 23 high bits
                      of b1 ^ b2, (b1, b2) = threefry(key, (i >> 32,
                      i & 0xFFFFFFFF)), as the mantissa of a float in
                      [1, 2), less 1

A key is an int64 tensor of shape (2,) holding two uint32 words. The
hash itself runs on int32 tensors holding the same bits: int32 adds and
left shifts wrap as uint32 ones do, and the one right shift of each
rotation is masked to its low bits, so the same ops give the same bits on
the CPU and on the card (no `torch.uint32` arithmetic, which CUDA does not
cover) at half the bytes of int64 words. A draw of element i depends only
on i, so `uniform(k, (10,))[:7]` equals `uniform(k, (7,))`: a row's draw
does not depend on the padded length.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _signed(v: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    v &= MASK
    return v - (1 << 32) if v >> 31 else v


def _add(x: Word, k: Word, c: int = 0) -> Word:
    """x + k + c mod 2^32 on int32 words (k a key word, c a constant)."""
    if isinstance(k, int):
        return x + _signed(k + c)
    return x + k + _signed(c) if c else x + k


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): int32 tensors or ints holding uint32 words in
    int32 form (`_signed`); x1 may be an int shared by every pair."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = _add(x1, ks[0])
    b = _add(x2, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = _rotl(b, r) ^ a
        a = _add(a, ks[(i + 1) % 3])
        b = _add(b, ks[(i + 2) % 3], i + 1)
    return a, b


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a seed that fits 32 bits."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _words(key: torch.Tensor) -> Tuple[Word, Word]:
    """The key's two words in int32 form: ints for a key on the CPU (no
    copy to the card, no sync), 0-dim int32 tensors for one on the card."""
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is an int64 (2,) tensor, got {key.dtype} "
                         f"{tuple(key.shape)}")
    if key.device.type == "cpu":
        return _signed(int(key[0])), _signed(int(key[1]))
    w = torch.where(key >= 1 << 31, key - (1 << 32), key).to(torch.int32)
    return w[0], w[1]


def _key(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """int32 words -> keys of int64 uint32 words, stacked on the last dim."""
    return torch.stack([b1, b2], dim=-1).long() & MASK


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)`: (n, 2) keys on key's device."""
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int32, device=key.device)
    return _key(*threefry2x32(k1, k2, 0, lo))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for data that fits 32 bits."""
    k1, k2 = _words(key)
    x = torch.tensor([_signed(int(data))], dtype=torch.int32,
                     device=key.device)
    return _key(*threefry2x32(k1, k2, 0, x))[0]


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device`
    (key's device by default). A key on the CPU is read as two ints, so a
    draw on the card needs no copy of it."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = key.device if device is None else torch.device(device)
    k1, k2 = _words(key)
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1.to(dev), k2.to(dev)
    n = 1
    for d in shape:
        n *= int(d)
    if n >= 1 << 31:
        raise ValueError(f"uniform: {n} draws; at most 2^31 - 1 (the "
                         "counter's high word stays 0)")
    i = torch.arange(n, dtype=torch.int32, device=dev)
    b1, b2 = threefry2x32(k1, k2, 0, i)
    mant = (((b1 ^ b2) >> 9) & 0x7FFFFF) | 0x3F800000
    return (mant.view(torch.float32) - 1.0).reshape(shape)
