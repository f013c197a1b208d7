"""Feature hashing: murmur3-128 with the +-1 sign-bit trick
(``ytklearn_tpu/io/feature_hash.py``, whole).

reference feature/FeatureHash.java:94-118: each feature name is
murmur3_128-hashed (seeded); the low 31 bits of the first 64-bit word pick a
bucket, bit 40 picks a ±1 sign multiplied into the value so collisions cancel
in expectation (unbiased hashing). Colliding features *sum* their signed
values. The hash below is the standard MurmurHash3 x64 128-bit algorithm, the
same one Guava's murmur3_128 implements, so bucket assignments match the
reference for identical seeds and UTF-8 names.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

_MASK64 = (1 << 64) - 1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK64
    k ^= k >> 33
    return k


_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AB90ED1F8779


def murmur3_x64_128(data: bytes, seed: int = 0) -> Tuple[int, int]:
    """Canonical MurmurHash3_x64_128; returns (h1, h2) as unsigned 64-bit."""
    length = len(data)
    h1 = seed & _MASK64
    h2 = seed & _MASK64
    nblocks = length // 16
    for b in range(nblocks):
        k1 = int.from_bytes(data[b * 16 : b * 16 + 8], "little")
        k2 = int.from_bytes(data[b * 16 + 8 : b * 16 + 16], "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK64
        h1 = (h1 * 5 + 0x52DCE729) & _MASK64
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK64
        h2 = (h2 * 5 + 0x38495AB5) & _MASK64

    tail = data[nblocks * 16 :]
    k1 = k2 = 0
    t = len(tail)
    if t >= 9:
        k2 = int.from_bytes(tail[8:].ljust(8, b"\0"), "little")
        k2 = (k2 * _C2) & _MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK64
        h2 ^= k2
    if t > 0:
        k1 = int.from_bytes(tail[:8][:min(t, 8)].ljust(8, b"\0"), "little")
        k1 = (k1 * _C1) & _MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK64
    h2 = (h2 + h1) & _MASK64
    return h1, h2


def murmur3_x64_128_h1(data: bytes, seed: int = 0) -> int:
    """First 64-bit word as a *signed* Java long (Guava HashCode.asLong)."""
    h1, _ = murmur3_x64_128(data, seed)
    return h1 - (1 << 64) if h1 >= (1 << 63) else h1


class FeatureHash:
    """reference: feature/FeatureHash.java (hashMap2Map :94-118)."""

    def __init__(self, bucket_size: int, seed: int, prefix: str = "hash_"):
        self.bucket_size = int(bucket_size)
        self.seed = int(seed)
        self.prefix = prefix

    def hash_name(self, name: str) -> Tuple[str, float]:
        """name -> (hashed bucket name, ±1 sign)."""
        h = murmur3_x64_128_h1(name.encode("utf-8"), self.seed)
        bucket = (h & 0x7FFFFFFF) % self.bucket_size
        sign = 2.0 * ((h & 0x10000000000) >> 40) - 1.0
        return f"{self.prefix}{bucket}", sign

    def hash_features(self, feats: Iterable[Tuple[str, float]]) -> List[Tuple[str, float]]:
        """Hash (name,val) pairs; collisions accumulate signed values
        (reference: FeatureHash.hashMap2Map)."""
        out: Dict[str, float] = {}
        for name, val in feats:
            hname, sign = self.hash_name(name)
            out[hname] = out.get(hname, 0.0) + sign * val
        return list(out.items())
