"""NTT-friendly prime generation for the RNS-CKKS moduli chain.

Role parity: replaces the parameter/modulus setup the reference delegates to
Lattigo (`orion/backend/lattigo/scheme.go:35-86` builds a chain from LogQ/LogP
bit sizes).  We generate the primes ourselves: for each requested bit size we
pick distinct primes p with p = 1 (mod 2N) so that the ring Z_p[X]/(X^N+1)
supports a negacyclic NTT.

Kernel constraint: every prime must satisfy p < 2^31 so that the CUDA
kernels' 32-bit Shoup/Montgomery arithmetic is overflow-free and every
product of two residues fits a signed int64 in the plain torch path (see
`modops.py`).  Bit
sizes > 30 in a config are therefore split into several <=30-bit primes by the
parameter layer before reaching this module.
"""

from __future__ import annotations

import random

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def generate_primes(bit_sizes: list[int], two_n: int, avoid: set[int] | None = None) -> list[int]:
    """One NTT-friendly prime per requested bit size.

    For bit size b we scan p = 2^b +- k*2N (k = 1, 2, ...) alternating above
    and below 2^b, taking the candidate closest to 2^b that is prime, distinct,
    and = 1 (mod 2N).  Scanning near 2^b keeps the scale drift |p - 2^b| small,
    which is what makes rescaling by p approximately divide the scale by 2^b.
    """
    avoid = set(avoid or ())
    out: list[int] = []
    for b in bit_sizes:
        if b > 30:
            raise ValueError(
                f"prime bit size {b} > 30: 32-bit modular arithmetic "
                "requires p < 2^31; split large moduli upstream")
        base = 1 << b
        # align to 1 mod 2N
        up = base + 1
        if (up - 1) % two_n:
            up = base + (two_n - base % two_n) + 1
        down = up - two_n
        found = None
        for _ in range(1 << 20):
            for cand in (up, down):
                if cand and cand not in avoid and cand.bit_length() == b + 1 and is_prime(cand):
                    # p has bit_length b+1 <=> 2^b <= p < 2^(b+1); also accept
                    # just-below primes when the above-scan leaves the band.
                    found = cand
                    break
                if cand and cand not in avoid and cand.bit_length() == b and is_prime(cand):
                    found = cand
                    break
            if found:
                break
            up += two_n
            down -= two_n
        if found is None:
            raise RuntimeError(f"no NTT prime found near 2^{b} for 2N={two_n}")
        avoid.add(found)
        out.append(found)
    return out


def primitive_root_2n(p: int, two_n: int) -> int:
    """A primitive 2N-th root of unity mod p (requires 2N | p-1)."""
    assert (p - 1) % two_n == 0
    cof = (p - 1) // two_n
    rng = random.Random(0xC0FFEE ^ p)
    while True:
        x = rng.randrange(2, p - 1)
        r = pow(x, cof, p)
        # ord(r) | 2N; r is primitive iff r^N = -1 (then ord does not divide N,
        # and any proper divisor of 2N divides N for 2N a power of two).
        if pow(r, two_n // 2, p) == p - 1:
            return r
