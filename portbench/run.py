"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md.
"""
import os
import sys
import time

T_START = time.time()
#: the interpreter's string hash seed for every run: set and dict orders,
#: and with them the program's work, then follow from `--seed` alone
HASH_SEED = "0"


def fixed_hash(cmd) -> float:
    """Run `cmd` (the interpreter's arguments) again in this process with
    PYTHONHASHSEED fixed, unless it already is; returns the time the first
    interpreter started the run."""
    if os.environ.get("PYTHONHASHSEED") == HASH_SEED:
        return float(os.environ.pop("PORTBENCH_T_START", T_START))
    os.environ["PYTHONHASHSEED"] = HASH_SEED
    os.environ["PORTBENCH_T_START"] = repr(T_START)
    os.execv(sys.executable, [sys.executable] + list(cmd))


if __name__ == "__main__":
    t_start = fixed_hash([os.path.abspath(__file__)] + sys.argv[1:])
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from portbench.harness import main

    sys.exit(main(t_start=t_start))
