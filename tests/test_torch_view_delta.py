"""The port's device view cache against the reference's
(`tests/test_view_delta.py`, and the view halves of
`tests/test_program_table.py`), twin by twin.

Each case runs the same churn through the reference's `TPUStack` (JAX on
the CPU) and the port's `TorchStack(device="cpu")` — the row-delta
kernels' plain versions. After every refresh the two views are bitwise
equal to each other and to a cold full upload, and the `view.*` counters
move alike in both. One counter is left out of the comparison:
`view.upload_bytes`, because the reference pads each delta to 32-row
chunks by repeating a row and the port ships the rows alone.

The single-dispatch carry's twins cover every case of the reference's
`TestCarryAdoption`: adoption, rejection on an inexact, uncommitted or
foreign-token window, a stop delta that never commits, a foreign row
overlaid, and the chain carry's row classification.

Also the port's own rule for writes in place: a view leased to a caller
is never written; a refresh under a lease writes into copies
(`view.copy_slots`), and the new view still equals a cold upload.
"""
import pytest

from nomad_tpu import mock
from nomad_tpu.structs.resources import NetworkResource, Port
from torch_chain_cases import one_torch_thread  # noqa: F401
from torch_view_cases import (BOTH, PORT, REF, assert_views_equal,
                              mini_nodes, mixed_job, seeded)

#: the view counters both packages keep (upload_bytes differs by padding)
COUNTERS = ("full_uploads", "ports_full_uploads", "delta_uploads",
            "delta_rows", "ports_words", "copy_slots", "carry_adopts",
            "carry_rows", "carry_rejects", "chain_adopts", "chain_rows",
            "chain_rejects")


class _Counters:
    """Per-package view.* counter deltas since construction (or since
    `reset`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.base = {p.name: p.counters("view.") for p in BOTH}

    def delta(self, pkg):
        now = pkg.counters("view.")
        return {k: now.get(k, 0) - self.base[pkg.name].get(k, 0)
                for k in COUNTERS}


def _node(i, drained=False):
    n = mock.node()
    n.id = f"node-{i}"
    if drained:
        n.scheduling_eligibility = "ineligible"
    return n


def _alloc(node_id, job_id="job-a", cpu=100, ports=()):
    nets = []
    if ports:
        nets = [NetworkResource(reserved_ports=[
            Port(label=f"p{p}", value=p) for p in ports])]
    return REF.alloc(node_id, job_id=job_id, cpu=cpu, networks=nets)


class Twin:
    """One cluster per package, fed the same objects."""

    def __init__(self, nodes):
        self.cl = {p.name: p.cluster(nodes) for p in BOTH}
        self.stack = {p.name: p.make_stack(self.cl[p.name]) for p in BOTH}
        self.reset()

    def each(self, fn):
        for p in BOTH:
            fn(p, self.cl[p.name])

    def upsert_alloc(self, a):
        self.each(lambda p, cl: cl.upsert_alloc(p.conv(a)))

    def remove_alloc(self, a):
        self.each(lambda p, cl: cl.remove_alloc(a.id, a.job_id))

    def upsert_node(self, n):
        self.each(lambda p, cl: cl.upsert_node(p.conv(n)))

    def remove_node(self, node_id):
        self.each(lambda p, cl: cl.remove_node(node_id))

    def refresh(self, what=""):
        """Refresh both views, adding what the refreshes moved to
        `self.moved` (the cold uploads of the check are not counted);
        assert the views equal to each other and to cold uploads;
        re-warm the caches; return the port's view."""
        views = {}
        for p in BOTH:
            c = _Counters()
            views[p.name] = p.view_np(self.stack[p.name].device_arrays())
            for k, v in c.delta(p).items():
                self.moved[p.name][k] = self.moved[p.name].get(k, 0) + v
        assert_views_equal(views["ref"], views["port"], f"{what} ref/port")
        for p in BOTH:
            assert_views_equal(views[p.name], p.cold_view(self.cl[p.name]),
                               f"{what} {p} cold")
            self.stack[p.name].device_arrays()   # re-warm
        return views["port"]

    def reset(self):
        self.moved = {p.name: {} for p in BOTH}


class TestDeltaParity:
    def test_randomized_churn_bit_identical(self):
        """Alloc upsert/remove, node drain/remove/re-add, port flips —
        after every churn batch the delta-refreshed views equal each
        other and a cold upload exactly, and the counters agree."""
        rng = seeded(7)
        nodes = [_node(i) for i in range(16)]
        tw = Twin(nodes)
        tw.refresh("warm")
        tw.reset()
        live = []
        for round_i in range(12):
            for _ in range(rng.randrange(1, 4)):
                op = rng.randrange(5)
                if op == 0 or not live:
                    ports = tuple(rng.sample(range(20000, 20050),
                                             rng.randrange(0, 3)))
                    a = _alloc(f"node-{rng.randrange(len(nodes))}",
                               job_id=f"job-{rng.randrange(3)}",
                               cpu=rng.randrange(10, 200), ports=ports)
                    tw.upsert_alloc(a)
                    live.append(a)
                elif op == 1:
                    tw.remove_alloc(live.pop(rng.randrange(len(live))))
                elif op == 2:
                    i = rng.randrange(len(nodes))
                    nodes[i] = _node(i, drained=rng.random() < 0.5)
                    tw.upsert_node(nodes[i])
                elif op == 3:
                    a = live.pop(rng.randrange(len(live)))
                    a.client_status = "complete"
                    tw.upsert_alloc(a)
                else:
                    i = rng.randrange(len(nodes))
                    tw.remove_node(f"node-{i}")
                    tw.upsert_node(nodes[i])
            tw.refresh(f"round {round_i}")
        assert tw.moved["ref"] == tw.moved["port"]
        assert tw.moved["port"]["delta_uploads"] > 0

    def test_row_growth_past_n_cap_falls_back_full(self):
        tw = Twin([_node(i) for i in range(8)])
        assert tw.cl["port"].n_cap == 64
        tw.refresh("warm")
        tw.reset()
        for i in range(8, 70):   # past the 64-row bucket
            tw.upsert_node(_node(i))
        assert tw.cl["port"].n_cap == 128
        tw.refresh("growth")
        assert tw.moved["port"]["full_uploads"] == 1
        assert tw.moved["ref"] == tw.moved["port"]

    def test_oversized_delta_falls_back_full(self):
        nodes = [_node(i) for i in range(40)]
        tw = Twin(nodes)
        tw.refresh("warm")
        tw.reset()
        for i, n in enumerate(nodes):   # touch 40 rows > 64 // 4
            tw.upsert_alloc(_alloc(n.id, cpu=10 + i))
        tw.refresh("oversize")
        assert tw.moved["port"]["full_uploads"] == 1
        assert tw.moved["ref"] == tw.moved["port"]

    def test_log_window_overflow_falls_back_full(self):
        from nomad_tpu_torch.tensor.cluster import DELTA_LOG_LEN

        nodes = [_node(i) for i in range(4)]
        tw = Twin(nodes)
        tw.refresh("warm")
        tw.reset()
        a = _alloc(nodes[0].id)
        for _ in range(DELTA_LOG_LEN + 10):  # wrap the hot log
            tw.upsert_alloc(a)
        tw.refresh("window overflow")
        assert tw.moved["port"]["full_uploads"] == 1
        assert tw.moved["ref"] == tw.moved["port"]

    def test_port_flips_delta_applied(self):
        """Port set/clear churn refreshes the port bitmap by words, not
        whole-tensor re-uploads."""
        nodes = [_node(i) for i in range(8)]
        tw = Twin(nodes)
        tw.refresh("warm")
        tw.reset()
        a = _alloc(nodes[2].id, ports=(21000, 21001))
        tw.upsert_alloc(a)
        v1 = tw.refresh("set")
        word = 21000 >> 5
        assert v1["ports_used"][2, word] & (1 << (21000 & 31))
        tw.remove_alloc(a)
        v2 = tw.refresh("clear")
        assert not (v2["ports_used"][2, word] & (1 << (21000 & 31)))
        assert tw.moved["port"]["ports_full_uploads"] == 0
        assert tw.moved["port"]["ports_words"] > 0
        assert tw.moved["ref"] == tw.moved["port"]

    @pytest.mark.parametrize("pkg", BOTH, ids=str)
    def test_concurrent_mutation_mid_apply_invalidates(self, pkg,
                                                       monkeypatch):
        """A mutation landing between the version capture and the delta
        read leaves the stored entry STALE, and the next refresh
        converges on the racer's rows — in both packages."""
        nodes = [_node(i) for i in range(8)]
        cl = pkg.cluster(nodes)
        stack = pkg.make_stack(cl)
        stack.device_arrays()
        cl.upsert_alloc(pkg.conv(_alloc(nodes[1].id, cpu=50)))
        racer = pkg.conv(_alloc(nodes[5].id, cpu=999))
        cls = type(cl)
        real = cls.hot_entries_since
        fired = {}

        def racing(self_cl, v0, limit):
            rows = real(self_cl, v0, limit)
            if not fired:
                fired["hit"] = True
                self_cl.upsert_alloc(racer)   # after the version capture
            return rows

        monkeypatch.setattr(cls, "hot_entries_since", racing)
        stack.device_arrays()
        assert fired, "race hook never ran"
        assert pkg.cache_entry(cl)["version"] < cl.version, \
            "entry marked current despite concurrent mutation"
        monkeypatch.setattr(cls, "hot_entries_since", real)
        view = pkg.view_np(stack.device_arrays())
        assert view["used"][cl.row_of[nodes[5].id], 0] == pytest.approx(999.)
        assert_views_equal(view, pkg.cold_view(cl), f"{pkg} post-race")


class TestUploadCounters:
    def test_small_churn_between_selects_is_delta_only(self):
        """Small churn between two solo selects performs ZERO full
        hot-tensor uploads, in both packages alike."""
        nodes = [_node(i) for i in range(8)]
        job = mock.job()
        job.task_groups[0].tasks[0].resources.cpu = 100
        job.task_groups[0].networks = []
        tw = Twin(nodes)
        sel = {}
        for p in BOTH:
            j = p.conv(job)
            sel[p.name] = [tw.stack[p.name].select(j, j.task_groups[0], 1)]
        c = _Counters()
        tw.upsert_alloc(_alloc(nodes[3].id, ports=(22001,)))
        for p in BOTH:
            j = p.conv(job)
            sel[p.name].append(tw.stack[p.name].select(j, j.task_groups[0],
                                                       1))
        d = c.delta(PORT)
        assert d["full_uploads"] == 0 and d["ports_full_uploads"] == 0
        assert d["delta_uploads"] == 1 and d["delta_rows"] >= 1
        assert c.delta(REF) == d
        for r, g in zip(sel["ref"], sel["port"]):
            assert r.node_ids == g.node_ids
            assert r.scores == pytest.approx(g.scores, abs=1e-6)


class TestCarryAdoption:
    """The single-dispatch carry (`note_dispatch_carry`, adopted by the
    next refresh): twins of tests/test_program_table.py's cases."""

    @staticmethod
    def _round(tw, jobs, ids, commit=True, **kw):
        res = {}
        for p in BOTH:
            c = _Counters()
            _c, res[p.name] = p.run_round(tw.cl[p.name], jobs, eval_ids=ids)
            for k, v in c.delta(p).items():
                tw.moved[p.name][k] = tw.moved[p.name].get(k, 0) + v
            if commit:
                p.commit_round(tw.cl[p.name], res[p.name], ids, **kw)
        for i in res["ref"]:
            assert res["ref"][i][0] == res["port"][i][0], i
        return res

    def test_adopted_view_bit_identical_to_cold_upload(self):
        rng = seeded(21)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(3)]
        ids = [f"ev-{i}" for i in range(3)]
        tw.reset()
        for round_i in range(5):
            self._round(tw, jobs, ids)
            tw.refresh(f"round {round_i}")
        assert tw.moved["ref"] == tw.moved["port"]
        assert tw.moved["port"]["carry_adopts"] >= 4

    def test_inexact_commit_rejects_carry(self):
        rng = seeded(4)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(2)]
        ids = ["ev-a", "ev-b"]
        self._round(tw, jobs, ids, exact=False)
        tw.reset()
        self._round(tw, jobs, ids, commit=False)
        assert tw.moved["port"]["carry_rejects"] == 1
        assert tw.moved["port"]["carry_adopts"] == 0
        assert tw.moved["ref"] == tw.moved["port"]
        tw.refresh("inexact")

    def test_window_from_other_dispatch_rejects_carry(self):
        rng = seeded(13)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(2)]
        ids = ["ev-a", "ev-b"]
        self._round(tw, jobs, ids, wrong_token=True)
        tw.reset()
        self._round(tw, jobs, ids, commit=False)
        assert tw.moved["port"]["carry_rejects"] == 1
        assert tw.moved["ref"] == tw.moved["port"]
        tw.refresh("other token")

    def test_adoption_happens_and_skips_upload(self):
        rng = seeded(2)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(3)]
        ids = [f"ev-{i}" for i in range(3)]
        self._round(tw, jobs, ids)
        tw.reset()
        self._round(tw, jobs, ids, commit=False)
        assert tw.moved["port"]["carry_adopts"] == 1
        assert tw.moved["port"]["carry_rows"] > 0
        assert tw.moved["ref"] == tw.moved["port"]

    def test_uncommitted_placement_rejects_carry(self):
        """An eval whose plan never committed would leave phantom usage
        in the carry: its missing window rejects adoption."""
        rng = seeded(6)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(2)]
        ids = ["ev-a", "ev-b"]
        self._round(tw, jobs, ids, skip_evals={"ev-b"})
        tw.reset()
        self._round(tw, jobs, ids, commit=False)
        assert tw.moved["port"]["carry_adopts"] == 0
        assert tw.moved["ref"] == tw.moved["port"]
        tw.refresh("uncommitted placement")

    def test_uncommitted_stop_delta_does_not_leak_into_view(self):
        """A program whose plan-relative stop delta rode the chain but
        whose plan never commits leaves no phantom release on the view:
        stop rows always overlay from the host."""
        from nomad_tpu.structs import Constraint

        rng = seeded(31)
        tw = Twin(mini_nodes())
        victim = REF.alloc("node-5", job_id="victim", cpu=500,
                           memory_mb=256, disk_mb=50)
        tw.upsert_alloc(victim)
        commit_job = mixed_job(rng, 1)
        commit_job.constraints.append(
            Constraint("${node.unique.id}", "node-5", "!="))
        doomed_job = mixed_job(rng, 1)
        doomed_job.task_groups[0].tasks[0].resources.cpu = 10 ** 6
        jobs, ids = [commit_job, doomed_job], ["ev-commit", "ev-doomed"]
        adopts = {}
        for p in BOTH:
            cl = tw.cl[p.name]
            plans = {1: p.stack_mod.PlanContext(
                stopped_allocs=[p.conv(victim)])}
            _c, res = p.run_round(cl, jobs, eval_ids=ids, plans=plans)
            assert res[1][0][0] is None, f"{p}: doomed eval placed"
            p.commit_round(cl, res, ids, skip_evals={"ev-doomed"})
            adopts0 = p.counter("carry_adopts")
            p.run_round(cl, jobs, eval_ids=ids, plans=plans)
            adopts[p.name] = p.counter("carry_adopts") - adopts0
            assert p.cold_view(cl)["used"][cl.row_of["node-5"], 0] >= 500
        assert adopts["port"] == adopts["ref"] == 1, \
            "adoption did not happen: the phantom-release path is untested"
        tw.refresh("uncommitted stop delta")

    def test_chain_carry_overlay_classification(self):
        """Row math of the chain carry decision: certified evidence rides
        verbatim, tail mutations past proven_version are judged against
        the head token's windows, stops, phantoms and foreign rows always
        overlay — the same split in both packages."""
        got = {}
        for p in BOTH:
            cl = p.cluster(mini_nodes())
            p.make_stack(cl).device_arrays()
            ent = p.cache_entry(cl)
            prev = ent["arrays"]
            carry = {
                "chain": True, "token": 777, "base_arrays": prev,
                "evals": {"eh"}, "stop_rows": {4},
                "used": prev.used, "dyn_free": prev.dyn_free,
                "predicted": {"eh": {5, 6}},
                "proven_version": cl.version,
                "stale": {3}, "adopt_rows": {1, 2},
            }
            # the tail: the head's own clean+exact commit on row 5, then
            # a foreign bump on row 7 that no window covers
            v_lo = cl.version
            cl._log_hot(5)
            cl.version += 1
            cl.mark_plan_window("eh", v_lo, cl.version, clean=True,
                                exact=True, token=777)
            cl._log_hot(7)
            cl.version += 1
            overlay = p.make_stack(cl)._chain_carry_overlay
            got[p.name] = (
                overlay(cl, ent, carry, prev, None),
                overlay(cl, ent, dict(carry, predicted=None), prev, None),
                overlay(cl, ent, dict(carry, token=778), prev, None))
        assert got["port"] == got["ref"]
        clean, unresolved, phantom = got["port"]
        assert clean == ({1, 2, 5}, {3, 4, 7})
        assert unresolved is None
        assert phantom[0] == {1, 2} and {5, 6} <= phantom[1]

    def test_foreign_mutation_overlays_on_top_of_carry(self):
        rng = seeded(8)
        tw = Twin(mini_nodes())
        jobs = [mixed_job(rng, i) for i in range(3)]
        ids = [f"ev-{i}" for i in range(3)]
        self._round(tw, jobs, ids)
        tw.upsert_alloc(REF.alloc("node-7", job_id="foreign", cpu=77,
                                  memory_mb=33, disk_mb=5))
        tw.reset()
        self._round(tw, jobs, ids, commit=False)
        assert tw.moved["port"]["carry_adopts"] == 1
        assert tw.moved["ref"] == tw.moved["port"]
        tw.refresh("foreign")


class TestLeasedViewIsNeverWritten:
    """The port's rule for writes in place, which the reference gets from
    buffer donation: no lease ⇒ the refresh writes the cached tensors;
    any lease ⇒ it writes copies (the copy slot) and the leased tensors
    stay bitwise what they were."""

    def _churn(self, cl, nodes, rng):
        for i in range(3):
            cl.upsert_alloc(PORT.conv(_alloc(
                nodes[rng.randrange(len(nodes))].id, cpu=rng.randrange(10, 90),
                ports=(23000 + i,))))
        n = _node(5, drained=True)
        cl.upsert_node(PORT.conv(n))

    def test_leased_tensors_unchanged_new_view_equals_cold(self):
        rng = seeded(3)
        nodes = [_node(i) for i in range(12)]
        cl = PORT.cluster(nodes)
        stack = PORT.make_stack(cl)
        held = stack.device_arrays(lease_token="held")
        before = PORT.view_np(held)
        c0 = PORT.counter("copy_slots")
        self._churn(cl, nodes, rng)
        fresh = stack.device_arrays()
        assert PORT.counter("copy_slots") == c0 + 1
        assert_views_equal(PORT.view_np(held), before, "leased view")
        assert fresh.used is not held.used
        assert fresh.ports_used is not held.ports_used
        new = PORT.view_np(fresh)
        PORT.stack_mod.release_view(cl, "held")
        assert_views_equal(new, PORT.cold_view(cl), "refresh under lease")

    def test_unleased_refresh_writes_in_place(self):
        rng = seeded(4)
        nodes = [_node(i) for i in range(12)]
        cl = PORT.cluster(nodes)
        stack = PORT.make_stack(cl)
        v1 = stack.device_arrays(lease_token="t")
        PORT.stack_mod.release_view(cl, "t")
        c0 = PORT.counter("copy_slots")
        self._churn(cl, nodes, rng)
        v2 = stack.device_arrays()
        assert PORT.counter("copy_slots") == c0
        assert v2.used is v1.used and v2.ports_used is v1.ports_used
        assert_views_equal(PORT.view_np(v2), PORT.cold_view(cl), "in place")

    def test_solo_select_leases_its_view(self, monkeypatch):
        """The solo `select` holds a lease while it runs: a refresh that
        races its launch writes copies, not the tensors it reads."""
        nodes = [_node(i) for i in range(8)]
        cl = PORT.cluster(nodes)
        stack = PORT.make_stack(cl)
        job = PORT.conv(mock.job())
        seen = {}
        real = PORT.stack_mod.place_task_group

        def racing(arrays, params, m, explain=False):
            seen["before"] = arrays.used.clone()
            seen["leases"] = set(PORT.cache_entry(cl)["leases"])
            cl.upsert_alloc(PORT.conv(_alloc(nodes[0].id, cpu=333)))
            PORT.make_stack(cl).device_arrays()   # a refresh mid-launch
            seen["after"] = arrays.used.clone()
            return real(arrays, params, m, explain=explain)

        monkeypatch.setattr(PORT.stack_mod, "place_task_group", racing)
        stack.select(job, job.task_groups[0], 1)
        assert len(seen["leases"]) == 1
        assert bool((seen["before"] == seen["after"]).all())
        assert not PORT.cache_entry(cl)["leases"]
