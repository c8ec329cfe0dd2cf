"""Device-discipline violation fixtures (NLD01, NLD03, NLD04) on torch.

Analyzed under the repo-relative path of a fused-dispatch module
(scheduler/stack.py — inside the TRANSFER, WAVE and hot-path scopes)
and asserted against the trailing `# NLDxx` markers with exact lines.
"""
import numpy as np
import torch

from nomad_tpu_torch.convert import to_device_async


def unledgered_upload(buf, dev):
    t = torch.from_numpy(buf).to(dev)  # NLD01
    return t


def unledgered_uploads(buf, dev):
    a = torch.as_tensor(buf).cuda()  # NLD01
    b = torch.as_tensor(buf, device=dev)  # NLD01
    c = to_device_async(buf, dev)  # NLD01
    d = torch.from_numpy(buf).to(device=dev, non_blocking=True)  # NLD01
    return a, b, c, d


def unledgered_copy_upload(dst, buf):
    host = torch.from_numpy(buf)
    dst.copy_(host)  # NLD01
    return dst


def unledgered_fetch():
    result = place_fake_kernel()
    host = result.sel_idx.cpu()  # NLD01
    return host


def unledgered_fetches(dev):
    result = place_fake_kernel()
    n = result.n_placed.item()  # NLD01
    rows = torch.zeros(4, device=dev)
    listed = rows.tolist()  # NLD01
    back = rows.to("cpu")  # NLD01
    pinned = torch.empty(4, pin_memory=True)
    pinned.copy_(rows)  # NLD01
    arr = result.sel_score.numpy()  # NLD01
    return n, listed, back, pinned, arr


def unledgered_wait(ev):
    ev.synchronize()  # NLD01  # NLJ05


def place_fake_kernel():
    """Device-producing by naming convention (place_*)."""


class TableCache:
    def alloc_unbooked(self, dev):
        self._ti = torch.zeros((4, 4), dtype=torch.int32, device=dev)  # NLD03
        return self._ti

    def upload_unbooked(self, buf, dev):
        self._tf = torch.from_numpy(buf).to(dev)  # NLD01  # NLD03
        return self._tf


def arithmetic_lane_fold(rows):
    used_l = torch.stack([_lane(r) for r in rows])
    dyn_l = torch.stack([_lane(r) for r in rows])
    bad = torch.sum(used_l, dim=0)  # NLD04
    worse = dyn_l[0] + dyn_l[1]  # NLD04
    also = used_l.sum(dim=0)  # NLD04
    return bad, worse, also


def arithmetic_chain_fold(dispatches, base):
    """Multi-carry chain fold: merging the per-dispatch carries
    arithmetically is the same float-order hazard as a lane fold — an
    adopted chain carry must be folded by bitwise selection against the
    certified rows, never summed or averaged."""
    used_l, dyn_l = torch.func.vmap(_lanes)(dispatches)
    folded = used_l[0] + used_l[1]  # NLD04
    folded = folded + used_l[2]  # NLD04
    avg = torch.mean(dyn_l, dim=0)  # NLD04
    acc = base.clone()
    acc += used_l[3]  # NLD04
    return folded, avg, acc


def stacked_pair_fold(used_l, dyn_l):
    used_l, dyn_l = torch.stack(used_l), torch.stack(dyn_l)
    return used_l.mean(dim=0), dyn_l * 2  # NLD04


def _lane(row):
    return row


def _lanes(row):
    return row, row


_NP = np.zeros(1)
