"""A cell, a traffic and a per-layer metric added as new files and entries
are found without editing any file that is there."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found(tmp_path):
    pkg = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    (pkg / "traffic" / "j1022.json").write_text(json.dumps(
        {"pulsar": "J1022+1001", "dm": 10.25, "period_s": 0.0164529,
         "ring_blocks": 4}))
    (pkg / "limits" / "fold.j1022.json").write_text(json.dumps(
        {"limits": {"subints_diff": 0.0, "hits_diff": 0.0,
                    "profile_err": 1e-4}}))
    (pkg / "metrics" / "blocks_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.blocks)\n")
    bench["workloads"].append({"name": "fold.j1022", "config": "caspsr_fold",
                               "traffic": "j1022", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "blocks_seen", "unit": "blocks",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "realtime_x",
                               "workloads": ["fold.j1022"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    probe = (
        "import json\n"
        "from portbench.spec import load_cell, reader\n"
        "from portbench.run import Context\n"
        "c = load_cell('fold.j1022')\n"
        "print(json.dumps([c.traffic['dm'], c.config['driver'],"
        " c.driver.__name__, c.driver.__file__.startswith(__import__('os')"
        ".getcwd()), c.limits['limits']['profile_err'],"
        " [m['name'] for m in c.per_layer],"
        " reader('blocks_seen')(Context(None, 7, '', 1.0))]))\n")
    # the copy's portbench first, the program from the repository
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got[:5] == [10.25, "fold", "portbench.drivers.fold", True, 1e-4]
    assert got[5] == ["h2d_gbps", "step_ms", "step_roofline",
                      "device_idle_pct", "blocks_seen"]
    assert got[6] == 7.0
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
