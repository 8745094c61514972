"""The lint gate on the port: the JAX package's analyzer
(`lodestar_tpu.analysis`, tests/test_tpulint.py's gate) run over
`lodestar_tpu_torch/` by path — its hygiene rules (metric names and
labels, bare excepts, blocking calls in async code) and its concurrency
tier (lock order, guarded-by inference, async lock safety) — must leave
no active finding.  Suppressions must carry their rationale (the
analyzer refuses a bare one), and no rule is switched off here.
"""

import subprocess
import sys
from pathlib import Path

from lodestar_tpu.analysis import analyze
from lodestar_tpu.analysis.rules import ALL_RULES

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "lodestar_tpu_torch"


def test_the_port_has_no_active_finding():
    findings = analyze([str(PORT)])
    active = [f for f in findings if not f.suppressed]
    assert not active, "tpulint findings in lodestar_tpu_torch/:\n" + "\n".join(
        f"{f.path}:{f.line}: {f.rule}: {f.message}" for f in active)
    names = {r.name for r in ALL_RULES}
    assert {"guarded-by", "lock-order", "async-lock-safety", "node-hygiene", "metric-hygiene"} <= names
    # the suppressions in force are the breaker's two benign-race reads
    suppressed = sorted((Path(f.path).name, f.rule) for f in findings if f.suppressed)
    assert ("supervisor.py", "guarded-by") in suppressed
    assert all(rule == "guarded-by" or name == "clock.py" for name, rule in suppressed)


def test_the_command_line_gate_passes_on_the_port():
    out = subprocess.run([sys.executable, "-m", "lodestar_tpu.analysis", "lodestar_tpu_torch/"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 finding(s)" in out.stdout + out.stderr
