"""The port's device program table against the reference's.

One feed of compiled programs (the reference's `TPUStack.compile_tg`,
carried as numpy) goes through both `DeviceProgramTable`s: the port's on
CPU tensors (its insert is the plain `index_copy_` version of the row
scatter) and the reference's on CPU XLA. They must assign the same rows,
produce the same static/dynamic specs and dynamic rows, hold equal
tables after every commit, give up (`prepare` → None) at the same
ceilings, flush at the same cap growth, and report equal `stats`.

Twins of the reference's `tests/test_program_table.py`
`TestTableBitParity`, `TestTableMechanics`, `TestGuardAndZeroUpload`,
`TestPortWordDelta` and `TestAttrsCompaction`, each run through both
packages on the same objects (the reference's mocks, carried into the
port over the wire; `tests/torch_view_cases.py`): the table-gather
dispatch bitwise the packed path within each package and equal to the
reference's (nodes exactly, scores within 1e-6), its carry the host fold
of its selections; dedup, cap growth, the over-ceiling fallback and LRU
recycling alike; a steady-state round that ships no packed program, no
table row and no `stack.*` byte — read on the port by its counting
`guard_scope`, which books only the dynamic rows; a port flip shipped as
words; attrs carried as int16.
"""
import random

import numpy as np
import pytest
import torch

from nomad_tpu import mock
from torch_chain_cases import one_torch_thread  # noqa: F401
from nomad_tpu.lib.transfer import default_ledger as jax_ledger
from nomad_tpu.scheduler.stack import TPUStack
from nomad_tpu.server import program_table as jpt
from nomad_tpu.structs import Constraint, Spread, SpreadTarget
from nomad_tpu.tensor import ClusterTensors

from nomad_tpu_torch.kernels import rows as kr
from nomad_tpu_torch.lib.transfer import default_ledger
from nomad_tpu_torch.server import program_table as tpt
from torch_view_cases import BOTH, mini_nodes, mixed_job, seeded


def _cluster(n_nodes=12):
    cl = ClusterTensors()
    for i in range(n_nodes):
        n = mock.node()
        n.id = f"node-{i}"
        n.node_resources.cpu = 4000
        n.node_resources.memory_mb = 8192
        cl.upsert_node(n)
    return cl


def _job(rng, i, extra_constraints=0):
    j = mock.job()
    j.task_groups[0].tasks[0].resources.cpu = rng.choice((100, 250, 400)) + i
    j.task_groups[0].tasks[0].resources.memory_mb = rng.choice((64, 128))
    j.task_groups[0].networks = []
    if i % 2 == 0:
        j.constraints.append(Constraint("${node.datacenter}", "dc1", "="))
    if i % 3 == 0:
        j.spreads.append(Spread(attribute="${node.datacenter}", weight=50,
                                spread_target=[SpreadTarget(value="dc1",
                                                            percent=60)]))
    if i % 5 == 0:
        j.constraints.append(Constraint(operand="distinct_hosts"))
    for k in range(extra_constraints):
        j.constraints.append(Constraint("${node.datacenter}", f"dc-{k}",
                                        "!="))
    return j


def _feed():
    """Rounds of programs: repeats (dedup), new content (inserts), a cap
    growth (flush) and an over-ceiling program (fallback)."""
    rng = random.Random(3)
    cl = _cluster()
    stack = TPUStack(cl)
    jobs = [_job(rng, i) for i in range(6)]

    def compile_(js, n_place=2):
        return [stack.compile_tg(j, j.task_groups[0], n_place, None)[0]
                for j in js]

    return [
        compile_(jobs[:3]),
        compile_(jobs[:3]),                      # steady state
        compile_(jobs[2:6]),                     # two new rows
        compile_([_job(rng, 7, extra_constraints=20)]),   # caps growth
        compile_([_job(rng, 8, extra_constraints=200)]),  # over ceiling
        compile_(jobs[:2], n_place=3),
    ]


def _assert_tables(ref_com, got_com):
    for r, g in zip(ref_com[:3], got_com[:3]):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape) and r.dtype == g.numpy().dtype
        np.testing.assert_array_equal(r, g.numpy())


@pytest.mark.parametrize("capacity", [None, 4], ids=["roomy", "lru_4"])
def test_program_table_matches_reference(capacity):
    ref = jpt.DeviceProgramTable(capacity=capacity)
    got = tpt.DeviceProgramTable(capacity=capacity, device="cpu")
    launches = kr.launch_count()
    for i, progs in enumerate(_feed()):
        rp, gp = ref.prepare(progs), got.prepare(progs)
        assert (rp is None) == (gp is None), i
        if rp is None:
            continue
        np.testing.assert_array_equal(rp.rows, gp.rows, err_msg=str(i))
        assert rp.sspec == gp.sspec and rp.dspec == gp.dspec, i
        assert rp.m == gp.m and rp.gen == gp.gen, i
        for a, b in ((rp.dyn_i, gp.dyn_i), (rp.dyn_f, gp.dyn_f),
                     (rp.dyn_u, gp.dyn_u)):
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        rc = ref.commit(rp, jax_ledger())
        gc = got.commit(gp, default_ledger())
        assert (rc is None) == (gc is None), i
        _assert_tables(rc, gc)
        assert ref.stats() == got.stats(), i
    assert got.flushes >= 2 and got.inserts > 3
    # CPU tables insert through the plain version, never the kernel
    assert kr.launch_count() == launches


def test_stale_generation_commit_rejected():
    rng = random.Random(3)
    stack = TPUStack(_cluster())
    j = _job(rng, 0)
    progs = [stack.compile_tg(j, j.task_groups[0], 2, None)[0]]
    table = tpt.DeviceProgramTable(device="cpu")
    prep = table.prepare(progs)
    with table._lock:
        table._flush_locked()   # a caps flush races the commit
    assert table.commit(prep, default_ledger()) is None


def test_insert_never_writes_committed_tables():
    """An insert copies the tables: handles an earlier commit returned
    keep their contents (a dispatch may still read them)."""
    rng = random.Random(5)
    stack = TPUStack(_cluster())
    table = tpt.DeviceProgramTable(device="cpu")
    jobs = [_job(rng, i) for i in range(3)]
    progs = [stack.compile_tg(j, j.task_groups[0], 2, None)[0]
             for j in jobs]
    first = table.commit(table.prepare(progs[:1]), default_ledger())
    before = [t.clone() for t in first[:3]]
    second = table.commit(table.prepare(progs[1:]), default_ledger())
    for old, snap, new in zip(first[:3], before, second[:3]):
        assert torch.equal(old, snap)
        assert old.data_ptr() != new.data_ptr()


def test_table_for_is_per_cluster_and_device():
    cl = _cluster(4)
    a = tpt.table_for(cl, "cpu")
    assert tpt.table_for(cl, "cpu") is a
    assert tpt.table_for(_cluster(4), "cpu") is not a
    assert a.device == torch.device("cpu")


# ---- twins on both packages (tests/torch_view_cases.py) --------------------


def _compile_on(p, cl, jobs, n_place=2):
    stack = p.make_stack(cl)
    out = []
    for j in jobs:
        j = p.conv(j)
        out.append(stack.compile_tg(j, j.task_groups[0], n_place, None)[0])
    return stack, out


def _paths(p, table, arrays, params):
    """(packed sel, packed score, table sel, table score, table carry) of
    one batch through the package's packed transport and its program
    table, as numpy."""
    if p.name == "ref":
        import jax.numpy as jnp

        from nomad_tpu.kernels.placement import (pack_params,
                                                 place_packed_chain,
                                                 place_table_chain)
        from nomad_tpu.parallel.mesh import stack_params

        dev = jnp.asarray
        led = jax_ledger()
    else:
        from nomad_tpu_torch.convert import tensor_from_numpy
        from nomad_tpu_torch.kernels.placement import (pack_params,
                                                       place_packed_chain,
                                                       place_table_chain)
        from nomad_tpu_torch.parallel.pad import stack_params

        def dev(a):
            return tensor_from_numpy(a, torch.device("cpu"))

        led = default_ledger()
    batched, m = stack_params(params)
    ibuf, fbuf, ubuf, spec = pack_params(batched)
    legacy = place_packed_chain(arrays, dev(ibuf), dev(fbuf), dev(ubuf),
                                spec, m)
    prep = table.prepare(params)
    assert prep is not None
    ti, tf, tu, _nb, _cnt = table.commit(prep, led)
    rows = prep.rows if p.name == "port" else dev(prep.rows)
    out, carry = place_table_chain(
        arrays, ti, tf, tu, rows, dev(prep.dyn_i), dev(prep.dyn_f),
        dev(prep.dyn_u), prep.sspec, prep.dspec, prep.m)
    n = len(params)
    return (np.asarray(legacy[0])[:n], np.asarray(legacy[1])[:n],
            np.asarray(out[0])[:n], np.asarray(out[1])[:n],
            tuple(np.asarray(c) for c in carry))


def _new_table(p, capacity=None):
    if p.name == "ref":
        return jpt.DeviceProgramTable(capacity=capacity)
    return tpt.DeviceProgramTable(capacity=capacity, device="cpu")


def _ledger_of(p):
    return jax_ledger() if p.name == "ref" else default_ledger()


def _assert_same_selection(ref, port, what):
    """Nodes equal; scores within 1e-6 (XLA's exp against torch's)."""
    np.testing.assert_array_equal(ref[0], port[0], err_msg=what)
    np.testing.assert_allclose(port[1], ref[1], rtol=0, atol=1e-6,
                               err_msg=what)


class TestTableBitParity:
    def test_randomized_batches_bit_identical_to_packed_path(self):
        """Table-gather dispatch == packed-upload dispatch, bit for bit,
        across randomized mixed batches, in each package; the port's
        selections equal the reference's."""
        got = {}
        for p in BOTH:
            rng = seeded(17)
            cl = p.cluster(mini_nodes())
            table = _new_table(p)
            rounds = []
            for round_i in range(6):
                jobs = [mixed_job(rng, rng.randrange(12))
                        for _ in range(rng.choice((2, 3, 4)))]
                stack, params = _compile_on(p, cl, jobs)
                lsel, lscore, tsel, tscore, _carry = _paths(
                    p, table, stack.device_arrays(), params)
                assert np.array_equal(lsel[:, :2], tsel[:, :2]), \
                    (p, round_i)
                assert np.array_equal(lscore[:, :2].view(np.uint32),
                                      tscore[:, :2].view(np.uint32)), \
                    (p, round_i)
                rounds.append((tsel[:, :2], tscore[:, :2]))
                cl.upsert_alloc(p.alloc(
                    f"node-{rng.randrange(12)}", job_id=f"churn-{round_i}",
                    cpu=rng.randrange(10, 80), memory_mb=32, disk_mb=10))
            got[p.name] = rounds
        for i, (r, g) in enumerate(zip(got["ref"], got["port"])):
            _assert_same_selection(r, g, f"round {i}")

    def test_carry_matches_host_fold_of_selection(self):
        """The chain's (used, dyn_free) carry equals the base view plus
        the selections it reports, in each package; the carries equal."""
        carries = {}
        for p in BOTH:
            rng = seeded(5)
            cl = p.cluster(mini_nodes())
            jobs = [mixed_job(rng, i) for i in range(3)]
            stack, params = _compile_on(p, cl, jobs)
            arrays = stack.device_arrays()
            _ls, _lc, sel, _sc, carry = _paths(p, _new_table(p), arrays,
                                               params)
            expect = np.array(arrays.used, copy=True)
            for i, prm in enumerate(params):
                ask = np.asarray(prm.ask, dtype=np.float32)
                for row in sel[i]:
                    if row >= 0:
                        expect[int(row)] += ask
            assert np.array_equal(carry[0], expect), p
            carries[p.name] = carry
        np.testing.assert_allclose(carries["port"][0], carries["ref"][0],
                                   rtol=0, atol=0)
        np.testing.assert_array_equal(carries["port"][1],
                                      carries["ref"][1])


def _dedup(p):
    rng = seeded(3)
    cl = p.cluster(mini_nodes())
    jobs = [mixed_job(rng, 0), mixed_job(rng, 2)]
    _s, params = _compile_on(p, cl, jobs)
    table = _new_table(p)
    p1 = table.prepare(params)
    assert p1 is not None and table.inserts == 2
    table.commit(p1, _ledger_of(p))
    _s2, params2 = _compile_on(p, cl, jobs)     # same content again
    p2 = table.prepare(params2)
    assert p2 is not None
    assert table.inserts == 2, f"{p}: steady state re-inserted rows"
    assert np.array_equal(p1.rows, p2.rows)
    return p1.rows.tolist(), table.stats()


def _caps_growth(p):
    from nomad_tpu.structs import Constraint

    rng = seeded(3)
    cl = p.cluster(mini_nodes())
    _s, params = _compile_on(p, cl, [mixed_job(rng, 0)])
    table = _new_table(p)
    table.commit(table.prepare(params), _ledger_of(p))
    gen0 = table.gen
    big = mixed_job(rng, 1)
    for _ in range(20):     # many constraints grow the c cap
        big.constraints.append(Constraint("${node.datacenter}", "dc1",
                                          "!="))
    _s2, params_big = _compile_on(p, cl, [big])
    prep = table.prepare(params_big)
    assert prep is not None
    assert table.gen > gen0, f"{p}: caps growth must flush the table"
    assert table.commit(prep, _ledger_of(p)) is not None
    return table.stats(), prep.sspec, prep.dspec


def _over_ceiling(p):
    from nomad_tpu.structs import Constraint

    ceilings = (jpt if p.name == "ref" else tpt).DIM_CEILINGS
    rng = seeded(3)
    cl = p.cluster(mini_nodes())
    j = mixed_job(rng, 1)
    for k in range(ceilings["c"] + 1):
        j.constraints.append(Constraint("${node.datacenter}", f"dc-{k}",
                                        "!="))
    _s, params = _compile_on(p, cl, [j])
    return _new_table(p).prepare(params), dict(ceilings)


def _lru(p):
    rng = seeded(11)
    cl = p.cluster(mini_nodes())
    table = _new_table(p, capacity=4)
    seen, order = set(), []
    for i in range(8):
        j = mixed_job(rng, 1)
        j.task_groups[0].tasks[0].resources.cpu = 100 + i   # unique
        _s, params = _compile_on(p, cl, [j])
        prep = table.prepare(params)
        assert prep is not None
        table.commit(prep, _ledger_of(p))
        seen.update(int(r) for r in prep.rows)
        order.append(prep.rows.tolist())
    assert seen <= set(range(4)), f"{p}: rows escaped the capacity"
    assert table.stats()["rows"] <= 4
    return order, table.stats()


class TestTableMechanics:
    @pytest.mark.parametrize("case", [_dedup, _caps_growth, _over_ceiling,
                                      _lru],
                             ids=["content_dedup_steady_state_inserts_nothing",
                                  "caps_growth_flushes_generation",
                                  "over_ceiling_program_falls_back",
                                  "lru_eviction_recycles_rows"])
    def test_mechanics_match_reference(self, case):
        got = {p.name: case(p) for p in BOTH}
        assert got["port"] == got["ref"]
        if case is _over_ceiling:
            assert got["port"][0] is None


def _ledger_delta(before, after):
    return {site: row["bytes"] - before.get(site, {}).get("bytes", 0)
            for site, row in after.items()
            if row["bytes"] != before.get(site, {}).get("bytes", 0)}


class TestGuardAndZeroUpload:
    def test_steady_state_table_path_guard_clean_zero_pack(self,
                                                           monkeypatch):
        """Steady state, in both packages: no packed program, no table
        row, no hot-row re-upload; the dynamic rows are the only program
        transfer, and the carry is adopted. The reference runs the window
        under `transfer_guard("disallow")`; torch has no guard, so the
        port's counting `guard_scope` must have booked exactly the
        dynamic rows' bytes in it — no `stack.*` byte."""
        from nomad_tpu_torch.lib.metrics import default_registry

        deltas = {}
        for p in BOTH:
            rng = seeded(9)
            cl = p.cluster(mini_nodes())
            jobs = [mixed_job(rng, i) for i in range(4)]
            ids = [f"ev-{i}" for i in range(4)]
            for _ in range(2):      # cold, then carry adoption warmed
                _c, res = p.run_round(cl, jobs, eval_ids=ids)
                p.commit_round(cl, res, ids)
            led0 = p.ledger()
            adopts0 = p.counter("carry_adopts")
            guarded0 = default_registry().counters(
                prefix="transfer.guarded_")
            monkeypatch.setenv("NOMAD_TPU_TRANSFER_GUARD", "disallow")
            _c, res = p.run_round(cl, jobs, eval_ids=ids)
            monkeypatch.delenv("NOMAD_TPU_TRANSFER_GUARD")
            assert len(res) == 4 and all(r[0][0] is not None
                                         for r in res.values())
            delta = _ledger_delta(led0, p.ledger())
            for site in ("select_batch.pack_buffers",
                         "select_batch.table_insert", "stack.hot_delta",
                         "stack.hot_full"):
                assert delta.get(site, 0) == 0, (p, site, delta)
            assert delta.get("select_batch.dyn_rows", 0) > 0, (p, delta)
            assert p.counter("carry_adopts") > adopts0
            if p.name == "port":
                guarded = default_registry().counters(
                    prefix="transfer.guarded_")
                assert guarded.get("bytes", 0) - guarded0.get("bytes", 0) \
                    == delta["select_batch.dyn_rows"], delta
            deltas[p.name] = sorted(delta)
        assert deltas["port"] == deltas["ref"]


class TestPortWordDelta:
    def test_port_flip_ships_words_not_rows(self):
        from nomad_tpu.structs.resources import NetworkResource, Port

        views = {}
        for p in BOTH:
            cl = p.cluster(mini_nodes())
            stack = p.make_stack(cl)
            stack.device_arrays()
            led0 = p.ledger()
            cl.upsert_alloc(p.alloc(
                "node-3", job_id="p", cpu=10, memory_mb=16, disk_mb=5,
                networks=[NetworkResource(reserved_ports=[
                    Port(label="x", value=21007)])]))
            view = p.view_np(stack.device_arrays())
            delta = _ledger_delta(led0, p.ledger())
            assert delta.get("stack.ports_word_delta", 0) > 0, (p, delta)
            assert delta.get("stack.ports_delta", 0) == 0, (p, delta)
            assert delta.get("stack.ports_full", 0) == 0, (p, delta)
            word = 21007 >> 5
            assert view["ports_used"][3, word] & np.uint32(1 << (21007 & 31))
            cold = p.cold_view(cl)
            for f, v in view.items():
                assert np.array_equal(v, cold[f]), (p, f)
            views[p.name] = view
        for f, v in views["ref"].items():
            np.testing.assert_array_equal(views["port"][f], v, err_msg=f)


class TestAttrsCompaction:
    def test_attrs_ride_int16_and_parity_holds(self):
        picks = {}
        for p in BOTH:
            cl = p.cluster(mini_nodes())
            stack = p.make_stack(cl)
            view = p.view_np(stack.device_arrays())
            assert view["attrs"].dtype == np.int16
            assert np.array_equal(view["attrs"],
                                  cl.attrs[: cl.n_cap].astype(np.int16))
            j = p.conv(mixed_job(seeded(1), 0))
            r = stack.select(j, j.task_groups[0], 1, None)
            assert r.node_ids[0] is not None
            picks[p.name] = (view["attrs"], r.node_ids[0])
        np.testing.assert_array_equal(picks["port"][0], picks["ref"][0])
        assert picks["port"][1] == picks["ref"][1]
