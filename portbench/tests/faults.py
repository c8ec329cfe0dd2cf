"""Faults planted under the timed path, one a function: each takes a
`patch(obj, name, value)` (pytest's `monkeypatch.setattr`, or a plain
one that undoes nothing, for a run on the card) and breaks the port
where it produces its answer. A run with any of them has to come out
not correct."""
from __future__ import annotations


def state_unchanged(patch):
    """Plan apply returns with the state unchanged: nothing committed."""
    from nomad_tpu_torch.server.state import StateStore

    patch(StateStore, "upsert_plan_results", lambda self, plan, result: None)


def client_update_dropped(patch):
    """The client's status push returns with the state unchanged: the
    completed allocs keep running, and the occupancy climbs."""
    from nomad_tpu_torch.server.state import StateStore

    patch(StateStore, "update_alloc_from_client", lambda self, update: None)


def half_the_batch(patch):
    """Half of each batch of evals is acked as complete unscheduled."""
    from nomad_tpu_torch.server.worker import Worker

    real = Worker.start_batch

    def start_batch(self, items, group_of=None):
        keep = max(len(items) // 2, 1)
        for ev, tok in items[keep:]:
            ev.status = "complete"
            self.server.apply_eval_update(ev)
            self.server.broker.ack(ev.id, tok)
        return real(self, items[:keep],
                    group_of=group_of[:keep] if group_of else None)

    patch(Worker, "start_batch", start_batch)


def answer_altered(patch):
    """The chain kernel's choices of each program in reverse step order:
    the same rows, so every plan commits as before, but at each step a
    row other than the best."""
    import torch

    from nomad_tpu_torch.kernels import placement

    real = placement.place_table_chain

    def chain(cluster, *args, **kw):
        flat, carry = real(cluster, *args, **kw)
        sel = flat[0]
        n = (sel >= 0).sum(dim=1, keepdim=True)
        steps = torch.arange(sel.shape[1], device=sel.device)[None, :]
        src = torch.where(steps < n, n - 1 - steps, steps)
        return (torch.gather(sel, 1, src.long()),) + tuple(flat[1:]), carry

    patch(placement, "place_table_chain", chain)


ALL = (state_unchanged, client_update_dropped, half_the_batch,
       answer_altered)
