# nomadlint fixture — parsed by tests/test_torch_lint.py, never imported.
# Device-side ordering and non-blocking queries: NLJ05 stays silent.
import torch


def ordered_on_the_device(x, stream, ev):
    ev.record(stream)
    torch.cuda.current_stream().wait_event(ev)
    torch.cuda.current_stream().wait_stream(stream)
    done = ev.query()
    return x, done


def timed_with_events(start, end):
    # a benchmark's elapsed time is read after the caller synchronized
    return start.elapsed_time(end)
