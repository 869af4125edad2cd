"""Code-generated documentation — the RapidsConf.scala:1052-1149 (configs.md)
and TypeChecks.scala:1188-1581 (supported_ops.md) analogues: docs are
generated FROM the registries so they cannot drift from the code.

Copied from ``spark_rapids_tpu/docs_gen.py``, pointed at the port's conf
registry, exec and expression rules and ``SIGS``; it writes
``torch_configs.md`` and ``torch_supported_ops.md`` beside the JAX
package's documents.

Run: ``python -m spark_rapids_tpu_torch.docs_gen [output_dir]``
"""
from __future__ import annotations

import os
import sys


def generate_configs_md() -> str:
    from . import config as cfg

    lines = [
        "<!-- generated by spark_rapids_tpu_torch.docs_gen — do not edit -->",
        "# Configuration of the PyTorch/CUDA port",
        "",
        "All configs, generated from the port's registry",
        "(`spark_rapids_tpu_torch/config.py`). Keys keep",
        "the `spark.rapids.*` namespace of the reference so its users find",
        "the same switches; `spark.sql.*` keys are Spark keys honored here.",
        "",
        "**Scope** says when the value is read: `per-query` keys are",
        "re-resolved at every query (set them live with `set_conf` on a",
        "long-running service — this covers `concurrentGpuTasks`, every",
        "`scheduler.*` key, batch sizing, retry budgets, metrics/trace",
        "levels); `session-init` keys are frozen when the `TorchSession` is",
        "constructed (the version shim) and changing them later has no",
        "effect.",
        "",
        "| Name | Default | Scope | Description |",
        "|---|---|---|---|",
    ]
    startup = cfg.startup_only_keys()  # shared with the conf-key lint
    for key in sorted(cfg._REGISTRY):
        e = cfg._REGISTRY[key]
        if e.internal:
            continue
        doc = " ".join(str(e.doc).split())
        scope = "session-init" if key in startup else "per-query"
        lines.append(f"| `{key}` | `{e.default}` | {scope} | {doc} |")
    lines += [
        "",
        "## Per-rule kill switches",
        "",
        "Every operator and expression replacement rule has an auto-derived",
        "boolean switch (default true) — the reference's",
        "`DataFromReplacementRule.confKey` invariant (RapidsMeta.scala:35-43):",
        "",
        "| Name | Disables |",
        "|---|---|",
    ]
    from .plan.overrides import exec_rules, expr_rules

    for r in sorted(exec_rules().values(), key=lambda r: r.conf_key):
        lines.append(f"| `{r.conf_key}` | exec {r.name} on device |")
    for r in sorted(expr_rules().values(), key=lambda r: r.conf_key):
        lines.append(f"| `{r.conf_key}` | expression {r.name} on device |")
    lines.append("")
    return "\n".join(lines)


def generate_supported_ops_md() -> str:
    from .plan.overrides import exec_rules, expr_rules

    lines = [
        "<!-- generated by spark_rapids_tpu_torch.docs_gen — do not edit -->",
        "# Supported operators and expressions of the PyTorch/CUDA port",
        "",
        "Generated from the port's replacement-rule registries",
        "(`spark_rapids_tpu_torch/plan/overrides.py`)",
        "— the `supported_ops.md` analogue (TypeChecks.scala:1581). A rule",
        "with *conditions* falls back to the CPU engine when its check",
        "fails; the explain log (`spark.rapids.sql.explain`) names the",
        "reason per node.",
        "",
        "## Execs",
        "",
        "| Exec | Conditions |",
        "|---|---|",
    ]
    for r in sorted(exec_rules().values(), key=lambda r: r.name):
        cond = "conditional (see check)" if r.check is not None else "—"
        lines.append(f"| {r.name} | {cond} |")
    lines += [
        "",
        "## Expressions",
        "",
        "| Expression | Input types (TypeSig) | Conditions |",
        "|---|---|---|",
    ]
    for r in sorted(expr_rules().values(), key=lambda r: r.name):
        cond = "conditional (see check)" if r.check is not None else "—"
        sig = r.sig.describe() if getattr(r, "sig", None) is not None else "any"
        lines.append(f"| {r.name} | {sig} | {cond} |")
    lines.append("")
    return "\n".join(lines)


#: the generated files, beside the JAX package's configs.md/supported_ops.md
CONFIGS_MD = "torch_configs.md"
SUPPORTED_OPS_MD = "torch_supported_ops.md"


def main(out_dir: str = "docs") -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, CONFIGS_MD), "w") as f:
        f.write(generate_configs_md())
    with open(os.path.join(out_dir, SUPPORTED_OPS_MD), "w") as f:
        f.write(generate_supported_ops_md())
    print(f"wrote {out_dir}/{CONFIGS_MD} and {out_dir}/{SUPPORTED_OPS_MD}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "docs")
