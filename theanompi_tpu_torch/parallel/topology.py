"""Peer-routing tables of GoSGD, in seeded NumPy.

A copy of ``theanompi_tpu/parallel/topology.py`` (which imports only NumPy;
the port keeps its own copy and imports nothing of the JAX package): the
random derangements of ``gosgd_peers='perm'``, the iid assignment maps of
``'iid'`` with their decomposition into collision rounds, and the
embedding of tables drawn over an active sub-fleet into full-width ones.
The tables are bit-equal to the JAX package's for the same arguments: the
generator is the frozen-legacy ``np.random.RandomState``, and the seeds
are the caller's (the exchanger's family seeds ``0x605`` and ``0x1d1``
plus ``gosgd_seed``).  ``GOSGD_Exchanger`` routes its gossip messages by
them with point-to-point sends and receives.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def derangements(n: int, k: int, seed: int = 0x605) -> np.ndarray:
    """k distinct random derangements of range(n) (static, seeded).

    The JAX package's draws exactly (same RandomState stream, same
    rejection rule)."""
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    out, seen = [], set()
    guard = 0
    while len(out) < k and guard < 10000:
        guard += 1
        p = rng.permutation(n)
        if n > 1 and (p == idx).any():
            continue
        key = p.tobytes()
        if key in seen:
            continue
        seen.add(key)
        out.append(p)
    return np.asarray(out)


def iid_maps(n: int, k: int, seed: int = 0x1d1) -> np.ndarray:
    """k static assignment maps with the reference's iid peer draws:
    ``maps[k][i]`` is sender i's destination, uniform over the other
    workers — NOT a bijection, so collisions (in-degree > 1) occur with
    the same probability as in the reference's independent draws."""
    if n == 1:
        return np.zeros((k, 1), dtype=np.int64)   # self is the only peer
    rng = np.random.RandomState(seed)
    maps = np.empty((k, n), dtype=np.int64)
    for m in range(k):
        draw = rng.randint(0, n - 1, size=n)
        # uniform over [n]\{i}: shift draws >= i up by one
        maps[m] = draw + (draw >= np.arange(n))
    return maps


def collision_rounds(dest: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Decompose an arbitrary assignment map into in-degree-rank rounds:
    round r holds the pairs (sender, dest) where sender is destination's
    r-th inbound.  Each round has unique sources AND unique destinations
    — a partial permutation one round of point-to-point sends can
    route — and every
    sender appears in exactly one round."""
    rounds: list = []
    seen: dict = {}
    for i, d in enumerate(dest):
        r = seen.get(int(d), 0)
        seen[int(d)] = r + 1
        while len(rounds) <= r:
            rounds.append([])
        rounds[r].append((i, int(d)))
    return rounds


def embed_active(sub_tables: np.ndarray, active: Sequence[int],
                 n: int) -> np.ndarray:
    """Lift routing tables over the ACTIVE sub-fleet into full-width
    tables: every inactive rank is a fixed point (``table[r][d] == d`` —
    its α and replica are untouched until readmission), and the active
    ranks route among themselves exactly as ``sub_tables`` prescribes
    over ``range(len(active))``.  At full membership it is the identity
    embedding."""
    act = np.asarray(list(active), dtype=np.int64)
    tables = np.tile(np.arange(n), (len(sub_tables), 1))
    if len(sub_tables) and len(act):
        tables[:, act] = act[np.asarray(sub_tables, dtype=np.int64)]
    return tables
