"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (see portbench/README.md).  The last line of
standard output is one JSON object; the numbers compared with the
reference, each beside its limit, are the last lines of standard error.
"""

import os
import sys

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench.core import env

    started = env.prepare(root)
    from portbench.core.harness import main

    sys.exit(main(sys.argv[1:], started))
