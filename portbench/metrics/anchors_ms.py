"""Host milliseconds a block in phase anchors (``ops/fold.py::
compute_anchors`` under ``FoldPipeline.run``): the ``anchors`` stage of the
program's own ``RunReport`` (``FoldConfig.report``, on in the traced run
only), its total over the blocks in the window."""

import re

_LINE = re.compile(r"^\s*anchors\s+([0-9.eE+-]+) s\s+\((\d+) calls")


def read(ctx):
    for line in ctx.report.splitlines():
        m = _LINE.match(line)
        if m and ctx.blocks:
            return float(m.group(1)) * 1e3 / ctx.blocks
    return None
