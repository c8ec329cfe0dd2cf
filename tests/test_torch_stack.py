"""The port's host compile and device view against the reference stack.

Same objects in both packages (the reference builds them; the port gets
them over the wire, replayed in the same order): `TorchStack.compile_tg`
must equal `TPUStack.compile_tg` field by field, exactly (values, shapes
and dtypes), and so must the padded programs; the port's uploaded view
must equal `TPUStack.device_arrays()` as numpy (the u32 port bitmap
arrives as int32 holding the same bits).
"""
import numpy as np
import pytest

import torch_cases as tc
from nomad_tpu.parallel.mesh import pad_params
from nomad_tpu.scheduler.stack import TPUStack

from nomad_tpu_torch.parallel.pad import pad_params as torch_pad_params
from nomad_tpu_torch.scheduler.stack import TorchStack


def _assert_programs_equal(ref, got):
    assert type(ref)._fields == type(got)._fields
    for f in type(ref)._fields:
        r, g = np.asarray(getattr(ref, f)), np.asarray(getattr(got, f))
        assert r.dtype == g.dtype, f
        np.testing.assert_array_equal(r, g, err_msg=f)


@pytest.mark.parametrize("name", sorted(tc.CASES))
def test_compile_tg_matches_reference(name):
    case = tc.build(name)
    port = tc.port_case(case)
    ref_stack = TPUStack(case.cluster, algorithm=case.algorithm)
    stack = TorchStack(port.cluster, algorithm=case.algorithm, device="cpu")
    ref, ref_m = ref_stack.compile_tg(
        case.job, case.job.task_groups[0], case.n_place, case.plan,
        sampled_rows=case.sampled_rows)
    got, m = stack.compile_tg(
        port.job, port.job.task_groups[0], case.n_place, port.plan,
        sampled_rows=case.sampled_rows)
    assert m == ref_m
    _assert_programs_equal(ref, got)
    (ref_pad,), ref_pm = pad_params([ref])
    (got_pad,), pm = torch_pad_params([got])
    assert pm == ref_pm
    _assert_programs_equal(ref_pad, got_pad)

    ref_view = ref_stack.device_arrays()
    view = stack.device_arrays()
    for f in type(ref_view)._fields:
        r = np.asarray(getattr(ref_view, f))
        g = getattr(view, f).numpy()
        if r.dtype == np.uint32:
            g = g.view(np.uint32)
        assert r.dtype == g.dtype, f
        np.testing.assert_array_equal(r, g, err_msg=f)


def test_view_reuploads_only_the_changed_group():
    """Each tensor group refreshes only when its key moves, and then by
    the rows the delta log names: written into the cached tensors (no
    lease is held), bit-equal to the host."""
    case = tc.build("plan_delta_ports")
    port = tc.port_case(case)
    cl = port.cluster
    stack = TorchStack(cl, device="cpu")
    v1 = stack.device_arrays()
    assert stack.device_arrays() is v1          # unchanged: cached
    cl.version += 1                             # a bump naming no row
    v2 = stack.device_arrays()
    assert all(getattr(v2, f) is getattr(v1, f) for f in v1._fields)
    row = next(iter(cl.row_of.values()))
    cl._log_hot(row)                            # hot tensors only
    cl.used[row, 0] += 7
    cl.version += 1
    v3 = stack.device_arrays()
    assert v3.used is v2.used and v3.capacity is v2.capacity
    assert v3.ports_used is v2.ports_used
    assert float(v3.used[row, 0]) == np.float32(cl.used[row, 0])
    cl._log_ports(row, word=3)                  # the port bitmap
    cl.ports_used[row, 3] ^= np.uint32(1)
    cl.ports_version += 1
    v4 = stack.device_arrays()
    assert v4.ports_used is v3.ports_used and v4.used is v3.used
    assert int(v4.ports_used[row, 3]) == \
        int(cl.ports_used[row:row + 1, 3].view(np.int32)[0])
    cl.node_version += 1                        # the static group
    v5 = stack.device_arrays()
    assert v5.capacity is not v4.capacity and v5.ports_used is v4.ports_used