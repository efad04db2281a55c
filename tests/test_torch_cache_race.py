"""A preprocess-cache insert racing the execution-time lookups of the same keys
(ROADMAP queue C, fault 9): the insert thread's fill of a cold batch lands in
the middle of the next batch's `_resolve_entries`.

The data are the failing case's: the seg baseline2/delayed corner under SC
W16A16, `ragged_clouds(4, seed=2)`, `max_batch` 4, `max_wait_s` 5 ms and a
16 MiB cache.  A cold full batch runs the all-miss path, whose rows go into
the cache on the pool's insert thread.  A barrier holds that insert after
`result_row` and before `PreprocessCache.insert` (the wrapped `insert` waits
on an event), so the same clouds sent again are assembled while the cache is
still empty.  Their batch's first execution-time lookup misses; the barrier
is released there, and the lookups of the other three rows wait until all
four inserts have landed, so they hit: one batch whose entries changed under
its lookups, taking the mixed (splice) path.  Then clouds[0] alone: an
all-hit batch of one real row and three filler rows.

Every response must be the port's `infer` of the padded batch that the trace
says it rode in, bitwise, as in tests/test_torch_corners_serve.py.
"""

import threading

import numpy as np

from _port import (
    MAX_BATCH,
    WAIT_S,
    assert_served_bitwise,
    corner_configs,
    port_params,
    ragged_clouds,
    wait_for,
    wait_records,
)
from _threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core.policy import ExecutionPolicy
from repro_torch.serve import RuntimeConfig, ServingRuntime, TraceConfig


def test_insert_lands_between_the_lookups_of_a_batch():
    _, cfg = corner_configs("seg", "baseline2", "delayed")
    params = port_params("seg")
    cold = ragged_clouds(MAX_BATCH, seed=2)
    clouds = cold + cold + cold[:1]
    policy = ExecutionPolicy(quant="sc_w16a16")
    rt = ServingRuntime(cfg, params, RuntimeConfig(
        max_batch=MAX_BATCH, max_wait_s=0.005, buckets=(cfg.n_points,), trace=TraceConfig(),
        cache_max_bytes=1 << 24), policy=policy, device="cpu")
    cache = rt.cache
    insert, lookup = cache.insert, cache.lookup
    held, release = threading.Event(), threading.Event()
    phase = {"name": "cold", "lookups": 0, "insert_threads": set()}

    def held_insert(key, row, pre):
        if phase["name"] == "cold":  # the cold batch's fill, on the insert thread
            phase["insert_threads"].add(threading.current_thread().name)
            held.set()
            assert release.wait(WAIT_S), "the barrier was never released"
        return insert(key, row, pre)

    def racing_lookup(key):
        got = lookup(key)
        if phase["name"] == "wave 2":
            phase["lookups"] += 1
            if phase["lookups"] == 1:  # after the first lookup: let the fill land
                release.set()
                wait_for(lambda: cache.stats().insertions >= MAX_BATCH, "the held inserts")
        return got

    cache.insert, cache.lookup = held_insert, racing_lookup
    try:
        rt.warmup()
        futs = [rt.submit(c) for c in cold]
        rt.start()
        outs = [f.result(timeout=WAIT_S) for f in futs]
        assert held.wait(WAIT_S), "the cold batch's fill never reached the cache"
        assert cache.stats().insertions == 0  # the fill is held: the cache is empty
        phase["name"] = "wave 2"
        futs = [rt.submit(c) for c in cold]
        outs += [f.result(timeout=WAIT_S) for f in futs]
        phase["name"] = "lone"
        outs.append(rt.infer(cold[0]))
        records = wait_records(rt, len(clouds))
        stats = rt.cache_stats()
    finally:
        release.set()
        rt.stop()
    # the fill ran on a thread of its own, and the second wave saw 1 miss, then 3 hits
    assert phase["insert_threads"] and threading.main_thread().name not in phase["insert_threads"]
    assert phase["lookups"] == MAX_BATCH
    real = [b for b in records if b.n_real]
    assert [b.n_real for b in real] == [MAX_BATCH, MAX_BATCH, 1]
    assert not real[1].preprocess_skipped and real[2].preprocess_skipped
    assert stats.hits == MAX_BATCH - 1 + 1 and stats.entries == MAX_BATCH
    assert assert_served_bitwise(cfg, params, rt, clouds, outs, [policy] * len(clouds)) >= 3
    for a, b in zip(outs[:MAX_BATCH], outs[MAX_BATCH:2 * MAX_BATCH]):
        np.testing.assert_array_equal(a, b)
