import sys

from .run import fixed_hash

if __name__ == "__main__":
    t_start = fixed_hash(["-m", "portbench"] + sys.argv[1:])
    from .harness import main

    sys.exit(main(t_start=t_start))
