"""Rank-table snapshot: batched consequence-combo -> ADSP rank lookup.

Port of ``annotatedvdb_tpu/conseq/table.py``.  The ranker's current table
compiles to a sorted snapshot:

- each term is one bit in a 64-bit vocabulary mask; bit 63 marks a term
  outside the vocabulary, so an unknown combo never aliases a known one;
- combos are order-insensitive by construction (a set IS its bitmask);
- coding status is one mask AND against the CODING_CONSEQUENCES bits.

Novel combos (mask not found) return rank -1; the host ranker learns them,
bumps its version, and the caller rebuilds the snapshot.

:meth:`RankTable.lookup_device` is the port of the reference's
``_rank_lookup`` (an XLA binary search over two uint32 lanes).  torch has
no unsigned 64-bit compare, so the table keeps each mask as an int64 key
with the sign bit flipped, ``(hi - 2**31) * 2**32 + lo``, which sorts in
the masks' unsigned order, and the lookup is one ``torch.searchsorted`` on
the table's device.  It is plain torch: the table holds a few hundred rows
and the loader calls it only for flushes with many novel combos.
"""

from __future__ import annotations

import numpy as np
import torch

from annotatedvdb_tpu_torch.conseq.groups import CODING_CONSEQUENCES
from annotatedvdb_tpu_torch.conseq.ranker import ConsequenceRanker

_SIGN = np.uint64(1 << 63)


def _order_key(masks: np.ndarray) -> np.ndarray:
    """int64 keys in the unsigned order of uint64 ``masks``."""
    return (np.asarray(masks, np.uint64) ^ _SIGN).view(np.int64)


class RankTable:
    def __init__(self, ranker: ConsequenceRanker,
                 device: torch.device | str = "cpu"):
        self.version = ranker.version
        vocab_terms = sorted({t for c in ranker.rankings for t in c.split(",")})
        # bit 63 is reserved as the unknown-term marker (see _mask)
        if len(vocab_terms) > 63:
            raise ValueError("consequence vocabulary exceeds 63 terms")
        self.vocab = {t: i for i, t in enumerate(vocab_terms)}

        masks = np.array(
            [self._mask(c.split(",")) for c in ranker.rankings], dtype=np.uint64
        )
        # exact (possibly fractional — legacy seed ranks like 2.5 loaded
        # with rank_on_load=False) rank values; the device table is int32,
        # so fractional tables take the host path
        ranks = np.array(list(ranker.rankings.values()), dtype=np.float64)
        self.integral = bool((ranks == np.round(ranks)).all())
        order = np.argsort(masks, kind="stable")
        self._masks = masks[order]
        self._ranks = ranks[order]
        self.coding_mask = self._mask(
            [t for t in CODING_CONSEQUENCES if t in self.vocab]
        )
        self.device = torch.device(device)
        # device copies; the rank lane is only valid when integral
        self.d_keys = torch.from_numpy(_order_key(self._masks)).to(self.device)
        self.d_ranks = torch.from_numpy(self._ranks.astype(np.int32)).to(self.device)

    def _mask(self, terms) -> np.uint64:
        """Combo -> bitmask; any term outside the vocabulary sets the
        reserved unknown bit (63) so the mask can never alias a known
        combo's mask — unknown combos must return rank -1, not the rank of
        their known subset."""
        m = np.uint64(0)
        for t in terms:
            if t in self.vocab:
                m |= np.uint64(1) << np.uint64(self.vocab[t])
            else:
                m |= np.uint64(1) << np.uint64(63)
        return m

    def encode(self, combos) -> np.ndarray:
        """Host: combos (lists/comma-strings) -> [N] uint64 masks."""
        out = np.empty(len(combos), np.uint64)
        for i, c in enumerate(combos):
            terms = c.split(",") if isinstance(c, str) else c
            out[i] = self._mask(terms)
        return out

    def lookup_host(self, masks: np.ndarray) -> np.ndarray:
        """Host-side batch lookup (numpy searchsorted); -1 = unknown combo.
        Returns float64 so fractional legacy ranks survive exactly."""
        idx = np.searchsorted(self._masks, masks)
        idx = np.clip(idx, 0, len(self._masks) - 1)
        hit = self._masks[idx] == masks
        return np.where(hit, self._ranks[idx], -1.0)

    def lookup_device(self, hi, lo) -> torch.Tensor:
        """Batch lookup on the table's device over the masks' (hi, lo)
        uint32 halves (host arrays); [N] int32 ranks on that device,
        -1 = unknown.  Only valid on integral tables (``self.integral``);
        callers route fractional tables through :meth:`lookup_host`."""
        if not self.integral:
            raise ValueError(
                "device rank table is int32; this table has fractional "
                "ranks — use lookup_host"
            )
        hi = torch.as_tensor(np.asarray(hi, np.int64)).to(self.device)
        lo = torch.as_tensor(np.asarray(lo, np.int64)).to(self.device)
        key = (hi - (1 << 31)) * (1 << 32) + lo
        m = self.d_keys.shape[0]
        idx = torch.searchsorted(self.d_keys, key).clamp_(max=m - 1)
        hit = self.d_keys[idx] == key
        return torch.where(hit, self.d_ranks[idx],
                           torch.full_like(self.d_ranks[idx], -1))

    def is_coding(self, masks: np.ndarray) -> np.ndarray:
        return (masks & self.coding_mask) != 0
