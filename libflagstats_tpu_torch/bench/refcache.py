"""Disk cache for the host-oracle counters the measurements gate on.

The port of ``libflagstats_tpu.bench.refcache``. The inputs are pure
functions of (n_words, seed, full_range), so the oracle counters they
gate on are too; at 64Mi words the host oracle costs seconds to minutes
per run, so it is computed once and kept under ``build/bench_cache/``
(gitignored; never the JAX package's ``.jax_cache/``). The file name
carries a hash of the oracle, the flag model and this module's source,
so an edit of the semantics never serves stale counters, and a digest of
the data, so a caller's mismatched array cannot poison an entry.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import sys

import numpy as np

from .. import flags as _flags_mod
from .. import oracle as _oracle_mod
from ..oracle import flagstat_numpy

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "bench_cache",
)


def _source_tag() -> str:
    # this module too: the pospopcnt reference is computed inline below
    return hashlib.sha256(
        (inspect.getsource(_oracle_mod) + inspect.getsource(_flags_mod)
         + inspect.getsource(sys.modules[__name__])).encode()
    ).hexdigest()[:10]


def _data_tag(x: np.ndarray) -> str:
    """Content digest of the input (~0.4 s for 128 MiB)."""
    buf = x if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x)
    return hashlib.sha256(buf).hexdigest()[:12]


def _load(path: str, shape: tuple) -> np.ndarray | None:
    try:
        ref = np.load(path)
    except (OSError, ValueError):
        return None
    return ref if ref.shape == shape else None


def _store(path: str, ref: np.ndarray) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, ref)
    except OSError:
        pass


def _path(kind: str, x_host, n_words, seed, full_range, cache_dir) -> str:
    return os.path.join(
        cache_dir or CACHE_DIR,
        f"bench_{kind}_{n_words}_s{seed}_fr{int(full_range)}"
        f"_{_source_tag()}_{_data_tag(x_host)}.npy")


def oracle_counters(x_host: np.ndarray, n_words: int, seed: int = 0,
                    full_range: bool = True, cache_dir: str | None = None) -> np.ndarray:
    """int64[32] flagstat counters of ``x_host``, disk-cached."""
    path = _path("oracle", x_host, n_words, seed, full_range, cache_dir)
    ref = _load(path, (32,))
    if ref is None:
        ref = flagstat_numpy(x_host).astype(np.int64)
        _store(path, ref)
    return ref


def pospopcnt_counters(x_host: np.ndarray, n_words: int, seed: int = 0,
                       full_range: bool = True, cache_dir: str | None = None) -> np.ndarray:
    """int64[16] positional popcounts of the same input, disk-cached."""
    path = _path("pospop", x_host, n_words, seed, full_range, cache_dir)
    ref = _load(path, (16,))
    if ref is None:
        x32 = x_host.astype(np.uint32)
        ref = np.array([np.count_nonzero((x32 >> k) & 1) for k in range(16)], dtype=np.int64)
        _store(path, ref)
    return ref
