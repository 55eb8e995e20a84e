"""Weight operands the kernel wrappers derive from parameters alone, shared by
``attention.py`` and ``conv.py``: the per-parameter-version cache that keeps
them (``_derived``) and the ``mma.m16n8k16`` fragment order of a B operand
(``fragment_order`` and its inverse).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["fragment_order", "fragment_order_inverse"]


class _DerivedWeights:
    """Tensors a wrapper derives from parameters alone (the prenorm fold, a
    cast, a re-layout), kept per parameter version so that a forward does
    not redo them.

    An entry is keyed on the identity of each source tensor (of its base
    where the caller passes a view such as ``weight.t()``: a view is a new
    object on every call but shares its base's version counter) and holds
    the sources by weak reference with their ``_version`` at the time. It is
    used again only while every reference still gives the same object (an
    ``id`` alone, like a ``data_ptr``, can be taken over by a new tensor)
    at the same version: an optimizer's in-place step, ``load_state_dict``
    and the EMA's ``copy_`` all raise ``_version``. A source that tracks no
    version (an inference tensor) is never cached. An entry goes when one of
    its sources is collected.

    While a CUDA graph captures (``graphs.py``), ``capturing`` is that
    graph's list: every value handed out goes into it, so that the graph
    keeps alive what it reads, and a value made during the capture is not
    kept here (the capture recorded its computation but did not run it)."""

    def __init__(self) -> None:
        self._entries: Dict[tuple, tuple] = {}
        self.enabled = True
        self.capturing: Optional[List[object]] = None
        self.hits = self.misses = 0

    def get(self, kind: str, sources: Sequence[torch.Tensor], make: Callable[[], object]):
        value = self._get(kind, sources, make) if self.enabled else make()
        if self.capturing is not None:
            self.capturing.append(value)
        return value

    def _get(self, kind: str, sources: Sequence[torch.Tensor], make: Callable[[], object]):
        roots = [t if t._base is None else t._base for t in sources]
        try:
            versions = [r._version for r in roots]
        except RuntimeError:  # inference tensors do not track a version
            return make()
        key = (kind,) + tuple(
            (id(r), tuple(t.shape), t.stride(), t.storage_offset()) for r, t in zip(roots, sources)
        )
        entry = self._entries.get(key)
        if entry is not None:
            refs, seen, value = entry
            if seen == versions and all(ref() is r for ref, r in zip(refs, roots)):
                self.hits += 1
                return value
        self.misses += 1
        value = make()
        if self.capturing is not None:
            return value
        entries = self._entries

        def drop(_ref, key=key):
            entries.pop(key, None)

        entries[key] = (tuple(weakref.ref(r, drop) for r in roots), versions, value)
        return value

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits, "misses": self.misses}


_derived = _DerivedWeights()


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """A projection weight [K, J] (J % 8 == 0) laid out as [K'/32, J/8, 32, 8],
    K' = K rounded up to 32 with zero rows: for each pair of k16 steps and
    each n8 tile of output columns, the 8 values each of the 32 lanes feeds
    to ``mma.m16n8k16`` as its B fragments (lane = 4·g + t holds, for column
    8·nt + g, rows 2t, 2t+1, 2t+8, 2t+9 of the first step, then of the
    second), so a lane's share is one 16-byte load and a warp's load 512
    contiguous bytes. A pure permutation of the (padded) weight;
    ``fragment_order_inverse`` undoes it."""
    K, J = w.shape
    if K % 32:
        w = torch.nn.functional.pad(w, (0, 0, 0, 32 - K % 32))
        K = w.shape[0]
    # k = 32·kp + 16·step + 8·half + 2·t + j;  column = 8·nt + g
    v = w.reshape(K // 32, 2, 2, 4, 2, J // 8, 8)  # kp, step, half, t, j, nt, g
    return v.permute(0, 5, 6, 3, 1, 2, 4).reshape(K // 32, J // 8, 32, 8).contiguous()


def fragment_order_inverse(f: torch.Tensor) -> torch.Tensor:
    """[K'/32, J/8, 32, 8] in fragment order back to [K', J]."""
    kp, nt = f.shape[:2]
    v = f.reshape(kp, nt, 8, 4, 2, 2, 2)  # kp, nt, g, t, step, half, j
    return v.permute(0, 4, 5, 3, 6, 1, 2).reshape(kp * 32, nt * 8).contiguous()
