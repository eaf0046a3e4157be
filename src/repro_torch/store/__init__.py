"""Virtual client population: disk-backed client store + paged training —
the port of ``repro.store``.

The store keeps the full population's per-client state (params, momentum,
EF residual, push-sum weight, last loss) in fsync'd row-chunk files behind
a manifest; the paging layer keeps only each round's fault-in closure
resident and overlaps next-round prefetch with this round's compute on
the device.
See :mod:`repro_torch.store.paging` for the closure/operator semantics and
:mod:`repro_torch.store.paged` for the drivers.
"""
from repro_torch.store.faults import (
    FaultInjector,
    InjectedCrash,
    StoreCorruptionError,
    StoreIOError,
    retry_transient,
)
from repro_torch.store.layout import CHECKSUM_ALGO, STORE_FORMAT, FieldSpec
from repro_torch.store.paged import (
    PagedRunner,
    ResidentDriver,
    bank_fields,
    make_plan,
)
from repro_torch.store.paging import (
    PagerStats,
    RoundPlan,
    RowCache,
    build_closure,
    build_plan,
    closure_bound,
    dense_partial_operator,
)
from repro_torch.store.prefetch import Prefetcher, Writeback
from repro_torch.store.store import ClientStore

__all__ = [
    "CHECKSUM_ALGO",
    "STORE_FORMAT",
    "FieldSpec",
    "FaultInjector",
    "InjectedCrash",
    "StoreCorruptionError",
    "StoreIOError",
    "retry_transient",
    "ClientStore",
    "PagedRunner",
    "ResidentDriver",
    "bank_fields",
    "make_plan",
    "PagerStats",
    "RoundPlan",
    "RowCache",
    "build_closure",
    "build_plan",
    "closure_bound",
    "dense_partial_operator",
    "Prefetcher",
    "Writeback",
]
