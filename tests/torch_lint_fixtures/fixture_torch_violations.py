# nomadlint fixture — parsed by tests/test_torch_lint.py, never imported.
# Trailing `# NLJxx` markers are the expected findings at those lines.
import torch


def hot_path_waits(x, stream, ev):
    torch.cuda.synchronize()                       # NLJ05
    torch.cuda.synchronize(x.device)               # NLJ05
    stream.synchronize()                           # NLJ05
    ev.synchronize()                               # NLJ05
    torch.cuda.current_stream().synchronize()      # NLJ05
    return x
