"""Near-miss fixtures the device rules must stay SILENT on (NLD01, NLD03,
NLD04) — torch shapes.

Same shapes as the violation fixture with the contract applied: every
transfer ledger-accounted (directly, or through a helper whose every
call site is covered), residency booked, lane carries folded by bitwise
selection; and the calls that only look like transfers (dtype casts,
host tensors, host allocations).
"""
import numpy as np
import torch

from nomad_tpu_torch.convert import to_device_async
from nomad_tpu_torch.lib.transfer import default_ledger


def ledgered_upload(buf, dev):
    led = default_ledger()
    with led.timed("select_batch.dyn_rows", int(buf.nbytes)):
        t = torch.from_numpy(buf).to(dev)
    return t


def covered_helper_upload(buf, led, dev):
    # the helper transfers; BOTH its call sites sit inside ledger
    # scopes, so it is covered interprocedurally
    with led.timed("stack.hot_delta", 4):
        a = _chunk_up(buf, dev)
    with led.scope():
        b = _chunk_up(buf, dev)
    return a, b


def _chunk_up(buf, dev):
    return to_device_async(buf, dev)


def branch_local_lambda_upload(pinned, buf, led, dev):
    # TWO same-named lambdas, one per branch: the pair is judged as a
    # group — every `up(...)` call site is covered
    if pinned:
        up = lambda a: torch.from_numpy(a).pin_memory().to(dev)  # noqa: E731
    else:
        up = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with led.timed("select_batch.pack_buffers", int(buf.nbytes)):
        return up(buf)


def guarded_fetch():
    from nomad_tpu_torch.lib.transfer import guard_scope

    result = place_fake_kernel()
    with guard_scope():
        host = result.sel_idx.cpu().numpy()
        n = result.n_placed.item()
    return host, n


def dtype_casts_are_not_transfers(t, dt):
    return (t.to(torch.int32), t.to(dtype=torch.float32), t.to(t.dtype),
            t.to(dt))


def host_values_are_not_transfers(buf):
    a = np.arange(3)
    t = torch.from_numpy(a)
    staged = torch.empty(8, dtype=torch.uint8, pin_memory=True)
    staged.copy_(torch.zeros(8, dtype=torch.uint8))
    return (a.tolist(), t.numpy(), torch.zeros(3).tolist(),
            torch.as_tensor([1, 2]).sum().item(), buf.tolist())


def place_fake_kernel():
    """Device-producing by naming convention (place_*)."""


class TableCacheBooked:
    def alloc_booked(self, hbm, dev):
        self._ti = torch.zeros((4, 4), dtype=torch.int32, device=dev)
        hbm.track("program_table.i32", self._ti)
        return self._ti

    def leased(self, hbm, dev, token):
        self._view = torch.empty((4, 4), device=dev)
        hbm.lease(token, "stack.view")
        return self._view

    def host_scratch(self):
        self._buf = torch.empty(16, dtype=torch.uint8, pin_memory=True)
        self._cpu = torch.zeros(4, device="cpu")
        return self._buf, self._cpu


def bitwise_lane_fold(rows, base):
    used_l = torch.stack([_lane(r) for r in rows])
    changed = torch.any(used_l != base[None], dim=-1)
    n_changed = changed.to(torch.int32).sum(dim=0)  # a mask count
    folded = torch.where(changed[0][:, None], used_l[0], base)
    return folded, n_changed


def bitwise_chain_fold(dispatches, base):
    # chain-carry adoption fold: each dispatch's certified rows REPLACE
    # the base by torch.where selection — bit-exact adoption, never an
    # arithmetic merge of the carries
    used_l, dyn_l = torch.vmap(_lanes)(dispatches)
    folded = base
    for k in range(3):
        take = torch.any(used_l[k] != folded, dim=-1)
        folded = torch.where(take[:, None], used_l[k], folded)
    adopted = torch.any(used_l != base[None], dim=-1)
    n_adopted = torch.sum(adopted.to(torch.int32))  # a mask count
    return folded, n_adopted, dyn_l


def plain_wave_fold(used_l, dyn_l, used0, dyn0):
    # kernels/placement.py place_table_wave_plain's fold
    used_l, dyn_l = torch.stack(used_l), torch.stack(dyn_l)
    changed = torch.any(used_l != used0[None], dim=-1) | (dyn_l != dyn0[None])
    collisions = (changed.to(torch.int32).sum(dim=0) > 1).sum().to(
        torch.int32)
    used_f, dyn_f = used0, dyn0
    for lane in range(used_l.shape[0]):
        m = changed[lane]
        used_f = torch.where(m[:, None], used_l[lane], used_f)
        dyn_f = torch.where(m, dyn_l[lane], dyn_f)
    return used_f, dyn_f, collisions


def _lane(row):
    return row


def _lanes(row):
    return row, row
