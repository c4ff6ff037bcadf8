"""Query-head -> KV-head maps for the attention kernels.

A map assigns each of the H query heads one of the KV heads. The even map
h // (H / KV) needs no table: the kernels compute it (and the plain
versions use a grouped reshape). Any other map, the floor map of a
tensor-parallel plan whose padded head count KV does not divide (hymba's
32 heads over 5 at tp = 16: real heads h // 5, the 7 padded ones on KV
head 0), goes to the kernels as one int32 table on the device:

    [ map (H) | rank (H) | offsets (KV + 1) | heads (H) ]

map[h] is h's KV head, rank[h] its place in that head's group; the
groups in CSR form follow: KV head g owns heads[offsets[g]:offsets[g+1]],
in increasing order. The forward and the dQ kernels read map[h]; the dK /
dV kernels and the paged split kernels walk a KV head's group; the paged
combine writes head h from row rank[h] of its group's partials.

`table(head_map, device)` builds the table once per (map, device) and
caches it: a decode step copies nothing from the host.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

HeadMap = Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def even_map(n_heads: int, n_kv: int) -> HeadMap:
    g = n_heads // n_kv
    return tuple(h // g for h in range(n_heads))


def normalize(head_map, n_heads: int, n_kv: int) -> Optional[HeadMap]:
    """A map as a host tuple, or None for the even map (or no map). A
    tensor is read with `tolist()`: pass a CPU tensor or a tuple where a
    device sync matters."""
    if head_map is None:
        if n_heads % n_kv:
            raise ValueError(f"{n_heads} query heads over {n_kv} KV heads "
                             "need a head map (no even map exists)")
        return None
    if isinstance(head_map, torch.Tensor):
        head_map = head_map.tolist()
    m = tuple(int(g) for g in head_map)
    if len(m) != n_heads or any(not 0 <= g < n_kv for g in m):
        raise ValueError(f"head map {m} does not map {n_heads} query heads "
                         f"onto {n_kv} KV heads")
    if n_heads % n_kv == 0 and m == even_map(n_heads, n_kv):
        return None
    return m


def group_sizes(head_map: Optional[Sequence[int]], n_heads: int,
                n_kv: int) -> Tuple[int, ...]:
    """The number of query heads each KV head serves."""
    if head_map is None:
        return (n_heads // n_kv,) * n_kv
    sizes = [0] * n_kv
    for g in head_map:
        sizes[g] += 1
    return tuple(sizes)


def max_group(head_map: Optional[Sequence[int]], n_heads: int,
              n_kv: int) -> int:
    return max(group_sizes(head_map, n_heads, n_kv))


def host_table(head_map: HeadMap, n_kv: int) -> Tuple[int, ...]:
    """The table's entries (see the module docstring)."""
    H = len(head_map)
    groups = [[h for h in range(H) if head_map[h] == g] for g in range(n_kv)]
    rank = [groups[g].index(h) for h, g in enumerate(head_map)]
    offsets = [0]
    for grp in groups:
        offsets.append(offsets[-1] + len(grp))
    heads = [h for grp in groups for h in grp]
    return tuple(head_map) + tuple(rank) + tuple(offsets) + tuple(heads)


@functools.lru_cache(maxsize=None)
def _table(head_map: HeadMap, n_kv: int, device: str) -> torch.Tensor:
    return torch.tensor(host_table(head_map, n_kv), dtype=torch.int32,
                        device=device)


def table(head_map: HeadMap, n_kv: int, device) -> torch.Tensor:
    """The int32 device table of `head_map`, built once per (map, device)."""
    return _table(tuple(head_map), n_kv, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _index(head_map: HeadMap, device: str) -> torch.Tensor:
    return torch.tensor(head_map, dtype=torch.long, device=device)


def index(head_map: HeadMap, device) -> torch.Tensor:
    """`head_map` as a long tensor on `device` (the plain versions' K/V
    expansion), built once per (map, device)."""
    return _index(tuple(head_map), str(torch.device(device)))
