"""Client<->server communication accounting (the paper's cost model).

The port's own copy of `src/repro/core/comm.py` (pure Python, no tensors):
the same byte formulas, so a ledger bills the same bytes in both packages
for the same per-message entry counts.

The paper reports communication as the number of transmitted LoRA entries
(float32 values) relative to dense LoRA; Figure 3 converts to *time* under
asymmetric up/down bandwidth.  We track both the paper-faithful value-only
bytes and a practical values+indices estimate (4B value + 4B index; a
bitmap-coded mask costs n/8 bytes and is cheaper below d≈0.97 — we report
min(index, bitmap) as the practical coding).

The practical coding is *live* accounting: `record_round` accumulates
`coded_message_bytes` per direction alongside the value-only totals, so
every experiment reports both `total_bytes` (paper-faithful) and
`total_coded_bytes` (what a real index/bitmap wire format would move).
"""
from __future__ import annotations

import dataclasses

VALUE_BYTES = 4
INDEX_BYTES = 4


def coded_message_bytes(values: int, per_message_params: int, messages: int,
                        value_bytes: float = VALUE_BYTES,
                        dense: bool = False) -> int:
    """Wire bytes for `values` transmitted entries spread over `messages`
    sparse messages of `per_message_params` entries each: the cheaper of
    index coding (value + 4B index each) and bitmap coding (value + one
    n/8-byte bitmap per message).  `dense=True` means entry positions are
    implicit (a low-rank factor message: `transport.LowRankCompress`), so
    the wire carries exactly the values — no index/bitmap coding."""
    if dense:
        return int(values * value_bytes)
    idx = values * (value_bytes + INDEX_BYTES)
    bitmap = values * value_bytes + (per_message_params // 8) * messages
    return int(min(idx, bitmap))


@dataclasses.dataclass
class CommLedger:
    total_params: int                   # dense LoRA entry count (the `P` vector)
    down_values: int = 0                # cumulative transmitted entries
    up_values: int = 0
    rounds: int = 0
    down_value_bytes: float = VALUE_BYTES   # 4.0 f32, 1.0 int8, 0.5 int4...
    up_value_bytes: float = VALUE_BYTES
    down_coded: int = 0                 # cumulative practical wire bytes
    up_coded: int = 0
    # dense-coded directions (low-rank factor messages): transmitted
    # entries carry no positions, so coding is exactly nnz * value_bytes
    down_dense: bool = False
    up_dense: bool = False

    def record_round(self, n_clients: int, down_nnz: float, up_nnz_total: float,
                     *, down_per_message=None, up_per_message=None):
        """down_nnz: average entries sent per client on download;
        up_nnz_total: sum of entries uploaded across clients.  The optional
        per-message sequences carry each client's actual message size so the
        index-vs-bitmap minimum is taken per message (heterogeneous cohorts
        mix coding choices); without them every message is billed at the
        per-client average."""
        down = int(down_nnz) * n_clients
        up = int(up_nnz_total)
        self.down_values += down
        self.up_values += up
        dpm = (down_per_message if down_per_message is not None
               else [down_nnz] * n_clients)
        upm = (up_per_message if up_per_message is not None
               else [up_nnz_total / max(n_clients, 1)] * n_clients)
        # builtin sum() is fine here — and only here — because byte counts
        # are exact integers: no association-dependent rounding to pin down
        self.down_coded += sum(  # reprolint: disable=host-reduction -- integer bytes
            coded_message_bytes(int(v), self.total_params, 1,
                                self.down_value_bytes, self.down_dense)
            for v in dpm)
        self.up_coded += sum(  # reprolint: disable=host-reduction -- integer bytes
            coded_message_bytes(int(v), self.total_params, 1,
                                self.up_value_bytes, self.up_dense)
            for v in upm)
        self.rounds += 1

    # --- paper-faithful (values only) ---
    @property
    def down_bytes(self) -> int:
        return int(self.down_values * self.down_value_bytes)

    @property
    def up_bytes(self) -> int:
        return int(self.up_values * self.up_value_bytes)

    @property
    def total_bytes(self) -> int:
        return self.down_bytes + self.up_bytes

    # --- practical coding (indices or bitmap, whichever is smaller) ---
    @property
    def down_coded_bytes(self) -> int:
        return int(self.down_coded)

    @property
    def up_coded_bytes(self) -> int:
        return int(self.up_coded)

    @property
    def total_coded_bytes(self) -> int:
        return int(self.down_coded + self.up_coded)

    def dense_equivalent_bytes(self, n_clients_per_round: int) -> int:
        """What dense LoRA would have cost over the same rounds."""
        return self.rounds * n_clients_per_round * self.total_params * 2 * VALUE_BYTES


def lora_dense_bytes(n_params: int) -> int:
    return n_params * VALUE_BYTES


def pack_capacity(n_params: int, k: int) -> int:
    """Static slot count for a packed sparse message whose expected Top-K
    support is `k` out of `n_params` entries.

    The capacity is `k` plus 12.5% slack (at least 64 slots): the
    histogram/fused selectors keep *every* entry tied at the threshold, so
    a message can carry slightly more than `k` values.  Engines treat a
    message whose nnz exceeds this capacity as an overflow and fall back
    to the dense aggregation path for that buffer — the slack only has to
    make overflow rare, not impossible.  The same formula as the
    reference's, so packed shapes line up across packages.
    """
    assert n_params >= 0 and k >= 0, (n_params, k)
    return int(min(n_params, k + max(k // 8, 64)))
