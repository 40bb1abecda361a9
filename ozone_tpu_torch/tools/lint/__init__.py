"""ozlint: an AST invariant analyzer, pointed at the port's tree.

Port of `ozone_tpu/tools/lint/`. The repository states hard invariants
in prose (deadline propagation, no blocking under a lock, fence-carrying
ring commits, launch plans not keyed on per-call widths, no swallowed
datapath errors, spans on every device dispatch edge, no payload copies,
bounded server queues), and each has already cost a bug in the
reference. `python -m ozone_tpu_torch.tools.lint ozone_tpu_torch/` walks
every file's AST and reports code that breaks an invariant without an
in-line justification (`# ozlint: allow[rule-id] -- reason`). The rule
ids, the suppression syntax and the output format are the reference's;
`dispatch-shape-stability` and `span-on-dispatch` watch the port's
counterparts of the JAX idioms (lru_cache'd launch plans; the kernel
launch, the pinned copy and the CUDA event edges).

The package stays import-light: no torch and nothing of `ozone_tpu`, so
the tier-1 gate runs it as a sub-second subprocess.
"""

from ozone_tpu_torch.tools.lint.core import (  # noqa: F401
    Finding,
    LintError,
    RULES,
    SourceFile,
    format_findings,
    lint_paths,
    lint_source,
    rewrite_legacy_suppressions,
)

__all__ = [
    "Finding",
    "LintError",
    "RULES",
    "SourceFile",
    "format_findings",
    "lint_paths",
    "lint_source",
    "rewrite_legacy_suppressions",
]
