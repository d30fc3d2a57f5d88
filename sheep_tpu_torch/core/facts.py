"""Tree facts (port of sheep_tpu/core/facts.py): one ascending pass over
the forest, printed with the exact TREEFAQS grammar that downstream plot
scripts grep.  Width is ``1 + pst_weight``, so fill is 0; ``core_id`` is
always 0 and ``halo_id`` is the first id of width > 3, as in the
reference."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import INVALID_JNID
from .forest import Forest


@dataclass
class Facts:
    vert_cnt: int
    edge_cnt: int
    width: int
    fill: int
    vert_height: int
    edge_height: int
    root_cnt: int
    halo_id: int
    core_id: int

    def print(self) -> None:
        print(f"TREEFAQS: width:{self.width}\troots:{self.root_cnt}")
        print(f"\tvheight:{self.vert_height}\teheight:{self.edge_height}")
        print(f"\tverts:{self.vert_cnt}\tedges:{self.edge_cnt}")
        print(f"\thalo:{self.halo_id}\tcore:{self.core_id}")
        print(f"\tfill:{self.fill}")


def compute_facts(forest: Forest, widths: np.ndarray | None = None) -> Facts:
    n = forest.n
    parent = forest.parent
    pst = forest.pst_weight.astype(np.int64)
    if widths is None:
        widths = 1 + pst
    fill = int((widths - pst - 1).sum())

    vheight = np.zeros(n, dtype=np.int64)
    eheight = np.zeros(n, dtype=np.int64)
    vert_height = 0
    edge_height = 0
    root_cnt = 0
    # sequential ascending DP (kids always precede parents)
    par = parent.astype(np.int64)
    par[parent == INVALID_JNID] = -1
    for i in range(n):
        vheight[i] += 1
        eheight[i] += pst[i]
        p = par[i]
        if p >= 0:
            if vheight[p] < vheight[i]:
                vheight[p] = vheight[i]
            if eheight[p] < eheight[i]:
                eheight[p] = eheight[i]
        else:
            vert_height = max(vert_height, int(vheight[i]))
            edge_height = max(edge_height, int(eheight[i]))
            root_cnt += 1

    halo = np.nonzero(widths > 3)[0]
    return Facts(
        vert_cnt=n,
        edge_cnt=int(pst.sum()),
        width=int(widths.max(initial=0)),
        fill=fill,
        vert_height=vert_height,
        edge_height=edge_height,
        root_cnt=root_cnt,
        halo_id=int(halo[0]) if len(halo) else INVALID_JNID,
        core_id=0 if n else INVALID_JNID,
    )
