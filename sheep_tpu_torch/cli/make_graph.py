"""make_graph: a seeded R-MAT graph as a ``.dat`` file (port of
sheep_tpu/cli/make_graph.py).

USAGE: make_graph log_n edge_factor output.dat [seed]
"""

from __future__ import annotations

import sys

from ..io.edges import write_edges
from ..utils import rmat_edges


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("USAGE: make_graph log_n edge_factor output.dat [seed]")
        return 1
    log_n = int(argv[0])
    factor = int(argv[1])
    out = argv[2]
    seed = int(argv[3]) if len(argv) > 3 else 1
    tail, head = rmat_edges(log_n, factor << log_n, seed=seed)
    write_edges(out, tail, head)
    print(f"wrote {out}: n=2^{log_n} records={factor << log_n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
