"""The spread of a cell's runs, as a bound is set from it: for each set
of runs (the files that hold each run's output, its result the last
line), each metric's median and the distance between its first and third
quartiles over the median (``statistics.quantiles(values, n=4)``).

    python3 benchmark/spread.py set1/*.out -- set2/*.out
"""

import json
import statistics
import sys

from harness.stats import spread


def main(argv) -> int:
    sets, cur = [], []
    for arg in argv:
        if arg == "--":
            sets.append(cur)
            cur = []
        else:
            cur.append(arg)
    sets.append(cur)
    for i, files in enumerate(sets, 1):
        values = {}
        for path in files:
            with open(path) as f:
                res = json.loads(f.read().strip().splitlines()[-1])
            for name, m in res["metrics"].items():
                values.setdefault(name, []).append(m["value"])
        for name, vs in values.items():
            print(f"set {i} {name}: {len(vs)} runs, median {statistics.median(vs)!r}, "
                  f"spread {spread(vs)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
