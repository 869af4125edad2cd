"""Version-compatibility seam — the SparkShims trait (L8).

Reference: SparkShims.scala (sql-plugin:73-200, ~60 methods abstracting
cross-version Spark behavior), ShimLoader.scala:26 (ServiceLoader discovery
of the provider matching the runtime version), shims/spark30X modules.

Standalone there is no host Spark, but the seam is load-bearing in the
design (SURVEY §1 L8: "keep the trait"): every Spark-version-dependent
SEMANTIC this engine implements routes through a shim method, so targeting
another Spark version is one subclass, not a code audit. The session
selects the shim from ``spark.rapids.tpu.sparkVersion``.

Copied whole from ``spark_rapids_tpu/shims.py``. The port's session reads
the ANSI and adaptive defaults, its CSV reader the ``nullValue`` default
and its Parquet writer the rebase mode (``io/writer.py::_rebase_guard``).
"""
from __future__ import annotations


class SparkShim:
    """Behavior knobs that differ across Spark versions."""

    version = "3.1"

    # Spark 3.0/3.1 default ANSI off; a 4.x shim would flip this
    def ansi_default(self) -> bool:
        return False

    # Spark 3.x: adaptive execution default off in 3.0/3.1, on in 3.2+
    def adaptive_default(self) -> bool:
        return False

    # CSV nullValue default (constant across 3.x; here for completeness)
    def csv_null_value(self) -> str:
        return ""

    # proleptic Gregorian parsing: 3.x uses the strict DateTimeFormatter
    # grammar (invalid dates → null); a 2.4 shim would be lenient
    def strict_date_parsing(self) -> bool:
        return True

    # decimal64 cap (DECIMAL128 arrives with newer plugin generations)
    def max_decimal_precision(self) -> int:
        return 18

    # spark.sql.parquet.datetimeRebaseModeInWrite default: writing dates
    # before the Gregorian cutover needs julian rebase the engine does not
    # perform — EXCEPTION refuses them loudly (Spark 3.1/3.2 default;
    # reference RebaseHelper.scala). CORRECTED writes proleptic values
    # as-is (newer defaults).
    def parquet_rebase_write(self) -> str:
        return "EXCEPTION"


class Spark311Shim(SparkShim):
    version = "3.1"


class Spark320Shim(SparkShim):
    version = "3.2"

    def adaptive_default(self) -> bool:
        return True


class Spark330Shim(Spark320Shim):
    version = "3.3"

    def parquet_rebase_write(self) -> str:
        return "CORRECTED"


_PROVIDERS = {s.version: s for s in (Spark311Shim, Spark320Shim, Spark330Shim)}


def get_shim(version: str | None) -> SparkShim:
    """ShimLoader.getSparkShims analogue: match the configured version
    prefix against registered providers; unknown versions fail loudly like
    the reference's 'no shim for version' error."""
    if not version:
        return Spark311Shim()
    for v, cls in sorted(_PROVIDERS.items(), reverse=True):
        if version.startswith(v):
            return cls()
    raise ValueError(
        f"no shim provider for Spark version {version!r} "
        f"(available: {sorted(_PROVIDERS)})"
    )
