"""Scheduler package of the port: reconciler, generic and system
schedulers, the torch stack, scalar oracle (reference `scheduler/`)."""

#: loaded from `stack` at first use: the stack imports torch, and the
#: codec imports `scheduler.util`, so every CLI call that decodes a
#: struct would otherwise pay torch's import
_FROM_STACK = ("PlanContext", "SelectResult", "TorchStack")


def __getattr__(name):
    if name in _FROM_STACK:
        from . import stack

        return getattr(stack, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
