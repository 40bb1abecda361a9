"""ozlint over the port (`ozone_tpu_torch/tools/lint/`).

`tests/test_lint.py` re-pointed at the port: zero unsuppressed findings
over `ozone_tpu_torch/`; each of the eight rules trips on its known-bad
fixture and stays quiet on the known-good one (`tests/lint_fixtures_torch/`,
with `dispatch-shape-stability` and `span-on-dispatch` written in the
port's idioms: lru_cache'd launch plans, the ctypes kernel launch, the
pinned copy and the CUDA event edges); the output format and the
suppression grammar are the reference's; the CLI imports neither torch
nor `ozone_tpu`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from ozone_tpu_torch.tools.lint import (
    RULES,
    format_findings,
    lint_paths,
    lint_source,
    rewrite_legacy_suppressions,
)
from ozone_tpu_torch.tools.lint import rules as _rules  # noqa: F401 - registers

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).resolve().parent / "lint_fixtures_torch"

RULE_IDS = [
    "deadline-propagation",
    "blocking-under-lock",
    "fence-carrying-commit",
    "dispatch-shape-stability",
    "error-swallowing",
    "span-on-dispatch",
    "datapath-no-copy",
    "bounded-queue",
]


def test_zero_findings_on_tree():
    """Every finding in ozone_tpu_torch/ is fixed or carries an in-line
    `# ozlint: allow[...] -- reason`."""
    findings = lint_paths([str(ROOT / "ozone_tpu_torch")], root=str(ROOT))
    assert not findings, format_findings(findings)


def test_rpc_condition_is_named_as_one_with_no_suppression():
    """The server's Condition is `_cond` (the rule reads a `cond` name as a
    Condition, whose wait releases it), and no marker hides anything: named
    `_lock` again, the waits in its stop() are findings."""
    src = (ROOT / "ozone_tpu_torch" / "net" / "rpc.py").read_text()
    assert "allow[blocking-under-lock]" not in src
    assert "self._cond = threading.Condition()" in src
    assert not [f for f in lint_source(src, path="ozone_tpu_torch/net/rpc.py")
                if f.rule == "blocking-under-lock"]
    seeded = src.replace("self._cond", "self._lock")
    findings = lint_source(seeded, path="ozone_tpu_torch/net/rpc.py")
    assert len([f for f in findings if f.rule == "blocking-under-lock"]) == 2
    # a Lock held across a non-Condition wait is caught
    bad = ("import threading\n"
           "class S:\n"
           "    def stop(self, ev, t):\n"
           "        with self._lock:\n"
           "            ev.wait(t)\n")
    assert [f.rule for f in lint_source(bad, path="ozone_tpu_torch/net/x.py")] \
        == ["blocking-under-lock"]


def test_dispatch_shape_stability_covers_the_plan_factories(tmp_path):
    """The port's lru_cache'd plan factories (codec/fused.py,
    fused_kernel.py, torch_coder.py, crc_device.py, lrc_math.py) stay clean,
    and an LRC-flavoured plan keyed on a batch width trips the rule."""
    codec = ROOT / "ozone_tpu_torch" / "codec"
    findings = lint_paths([str(codec / n) for n in (
        "fused.py", "fused_kernel.py", "torch_coder.py", "crc_device.py",
        "lrc_math.py")], root=str(ROOT))
    assert not [f for f in findings if f.rule == "dispatch-shape-stability"]
    bad = tmp_path / "bad_lrc_plan.py"
    bad.write_text(
        "# ozlint: path ozone_tpu_torch/codec/lrc_plan.py\n"
        "from functools import lru_cache\n\n\n"
        "@lru_cache(maxsize=512)\n"
        "def lrc_repair_plan(options, erased, batch):\n"
        "    return options, erased, batch\n")
    assert any(f.rule == "dispatch-shape-stability"
               for f in lint_paths([str(bad)]))


def test_span_on_dispatch_names_the_port_edges():
    """The kernel launch in fused_kernel.py and the pinned copy, event
    record and synchronize in pipeline.py are edges: their markers are the
    only thing between them and a finding."""
    for rel in ("codec/fused_kernel.py", "codec/pipeline.py"):
        text = (ROOT / "ozone_tpu_torch" / rel).read_text()
        assert "allow[span-on-dispatch]" in text
        stripped = "\n".join(ln.split("  # ozlint:")[0]
                             for ln in text.splitlines())
        findings = lint_source(stripped, path=f"ozone_tpu_torch/{rel}")
        assert any(f.rule == "span-on-dispatch" for f in findings), rel


def test_all_eight_rules_registered():
    for rid in RULE_IDS:
        assert rid in RULES, f"rule {rid} not registered"
        assert RULES[rid].summary and RULES[rid].rationale
    assert set(RULES) == set(RULE_IDS)


def test_cli_check_exits_zero_and_imports_no_torch_nor_reference():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from ozone_tpu_torch.tools.lint.__main__ import main\n"
         "rc = main(['--check', 'ozone_tpu_torch'])\n"
         "assert 'torch' not in sys.modules, 'lint imported torch'\n"
         "assert not [m for m in sys.modules if m == 'ozone_tpu' or "
         "m.startswith('ozone_tpu.')], 'lint imported ozone_tpu'\n"
         "sys.exit(rc)"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("0 findings")


def test_cli_nonzero_on_findings_and_list_rules(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(FIXTURES.joinpath("bad_error_swallowing.py").read_text())
    proc = subprocess.run(
        [sys.executable, "-m", "ozone_tpu_torch.tools.lint", str(bad)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "error-swallowing" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "ozone_tpu_torch.tools.lint", "--list-rules"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    for rid in RULE_IDS:
        assert rid in proc.stdout


@pytest.mark.parametrize("rule", RULE_IDS)
def test_bad_fixture_trips_its_rule(rule):
    path = FIXTURES / f"bad_{rule.replace('-', '_')}.py"
    findings = lint_paths([str(path)])
    assert findings, f"{path.name} tripped nothing"
    assert {f.rule for f in findings} == {rule}, format_findings(findings)
    assert len(findings) >= 2, format_findings(findings)


@pytest.mark.parametrize("rule", RULE_IDS)
def test_good_fixture_is_clean(rule):
    path = FIXTURES / f"good_{rule.replace('-', '_')}.py"
    findings = lint_paths([str(path)])
    assert not findings, format_findings(findings)


@pytest.mark.parametrize("rule", ["deadline-propagation", "blocking-under-lock",
                                  "fence-carrying-commit", "error-swallowing",
                                  "datapath-no-copy", "bounded-queue"])
def test_unchanged_rules_answer_the_reference_fixtures_alike(rule):
    """The six rules the port keeps as they are give the reference's
    findings on the reference's own fixtures (line for line)."""
    from ozone_tpu.tools.lint import lint_paths as j_lint_paths

    ref = Path(__file__).resolve().parent / "lint_fixtures"
    for kind in ("bad", "good"):
        path = ref / f"{kind}_{rule.replace('-', '_')}.py"
        got = [(f.line, f.rule, f.message) for f in lint_paths([str(path)])]
        want = [(f.line, f.rule, f.message) for f in j_lint_paths([str(path)])]
        assert got == want


def test_finding_output_format_golden():
    src = ("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
           "import socket\n"
           "s = socket.create_connection(('h', 1), timeout=9.5)\n")
    findings = lint_source(src, path="ozone_tpu_torch/client/_fx.py")
    assert len(findings) == 1
    assert findings[0].render() == (
        "ozone_tpu_torch/client/_fx.py:3: deadline-propagation: socket "
        "connect timeout is a numeric literal — derive it from "
        "resilience.op_timeout()/Deadline.timeout() or a documented "
        "env knob")
    assert format_findings(findings).endswith("\nozlint: 1 finding")
    assert format_findings([]).strip() == "ozlint: 0 findings"


def test_suppression_same_line_with_reason():
    src = ("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
           "s.settimeout(5)  # ozlint: allow[deadline-propagation]"
           " -- fixture reason\n")
    assert not lint_source(src, path="x.py")


def test_suppression_own_line_covers_next_statement():
    src = ("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
           "# ozlint: allow[deadline-propagation] -- fixture reason\n"
           "s.settimeout(\n    5)\n")
    assert not lint_source(src, path="x.py")


def test_suppression_requires_reason():
    src = ("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
           "s.settimeout(5)  # ozlint: allow[deadline-propagation]\n")
    findings = lint_source(src, path="x.py")
    assert [f.rule for f in findings] == ["suppression-format"]
    assert "missing `-- reason`" in findings[0].message


def test_suppression_unknown_rule_is_flagged():
    findings = lint_source("s = 1  # ozlint: allow[no-such-rule] -- whatever\n",
                           path="x.py")
    assert [f.rule for f in findings] == ["suppression-format"]


def test_suppression_for_other_rule_does_not_mask():
    src = ("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
           "s.settimeout(5)  # ozlint: allow[error-swallowing] -- wrong rule\n")
    findings = lint_source(src, path="x.py")
    assert "deadline-propagation" in {f.rule for f in findings}


def test_seeding_fixed_violation_back_fails():
    """A literal connect timeout seeded into client/native_dn.py and an
    unfenced DeleteKey into client/re_encode.py are caught."""
    real = (ROOT / "ozone_tpu_torch" / "client" / "native_dn.py").read_text()
    fenced = 'timeout = resilience.op_timeout(_connect_timeout_s(), "connect")'
    assert fenced in real
    findings = lint_source(real.replace(fenced, "timeout = 120.0"),
                           path="ozone_tpu_torch/client/native_dn.py")
    assert any(f.rule == "deadline-propagation" for f in findings)
    re_enc = (ROOT / "ozone_tpu_torch" / "client" / "re_encode.py").read_text()
    seeded = re_enc.replace(
        "om.commit_key(session, groups, writer.bytes_written)",
        "om.submit(rq.DeleteKey(volume, bucket, key))\n"
        "    om.commit_key(session, groups, writer.bytes_written)")
    findings = lint_source(seeded, path="ozone_tpu_torch/client/re_encode.py")
    assert any(f.rule == "fence-carrying-commit" for f in findings)


def test_fix_suppressions_rewrites_legacy_marker(tmp_path):
    f = tmp_path / "legacy.py"
    f.write_text("# ozlint: path ozone_tpu_torch/client/_fx.py\n"
                 "import time\n"
                 "time.sleep(d)  # resilience-lint: allow\n")
    assert rewrite_legacy_suppressions([str(f)]) == [str(f)]
    text = f.read_text()
    assert "resilience-lint" not in text
    assert "# ozlint: allow[deadline-propagation] -- " in text
    assert not lint_paths([str(f)])


def test_analysis_is_fast_in_process():
    """The AST pass over the port's tree (imports excluded) stays inside
    the tier-1 budget, scaled by the rig's load."""
    t0 = time.monotonic()
    lint_paths([str(ROOT / "ozone_tpu_torch")], root=str(ROOT))
    took = time.monotonic() - t0
    try:
        load = os.getloadavg()[0]
    except OSError:
        load = 1.0
    scale = min(4.0, max(1.0, load / max(1, os.cpu_count() or 1)))
    assert took < 10.0 * scale, f"lint pass took {took:.1f}s"


def test_resilience_lint_no_hardcoded_timeouts_or_retry_sleeps():
    """The deadline rule over the directories the reference's old regex
    guarded (client/, lifecycle/, the codec service)."""
    pkg = ROOT / "ozone_tpu_torch"
    findings = lint_paths([str(pkg / "client"), str(pkg / "lifecycle"),
                           str(pkg / "codec" / "service.py")],
                          rules=["deadline-propagation"], root=str(ROOT))
    assert not findings, format_findings(findings)
