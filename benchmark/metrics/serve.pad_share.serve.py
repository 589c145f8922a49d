"""serve.pad_share.serve: the share, in %, of the rows GPServer computed
that its power-of-two buckets added: `serve.pad_rows` over `serve.rows` +
`serve.pad_rows`, from the program's own counters.  The counters count
from the process's start, and run.py runs one cell in a process, so the
share covers the whole run: set-up's warm predict at each bucket (16383
rows at chunk 8192, none of them padding) and the whole window, not the
traced part alone.  None where the program counts no rows."""

from pathlib import Path

from harness.spec import module


def read(run):
    c = module(Path(__file__).resolve().parents[2], "systems", "gp_counts").counts()
    if not c or "serve.rows" not in c:
        return None
    rows, pad = c["serve.rows"], c.get("serve.pad_rows", 0)
    return 100.0 * pad / (rows + pad) if rows + pad else None
