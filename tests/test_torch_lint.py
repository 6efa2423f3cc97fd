"""The JAX package's static lint (``repro.analysis``) held over the port:
``src/repro_torch`` and ``chip_smoke.py`` have zero findings under every
rule (lock discipline, blocking calls under a lock, thread joins, bare
acquires, unused imports), and each suppression names a shipped rule
and gives its reason, as ``tests/test_lint.py`` requires of
``src/repro``."""
import os

import pytest

from repro.analysis.core import default_rules, lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = [os.path.join(REPO, "src", "repro_torch"),
         os.path.join(REPO, "chip_smoke.py")]


@pytest.fixture(scope="module")
def result():
    return lint_paths(PATHS)


def test_port_tree_is_lint_clean(result):
    assert result.files > 70, "lint walked suspiciously few files"
    assert result.findings == [], "\n".join(str(f) for f in result.findings)


def test_every_port_suppression_has_rule_and_reason(result):
    known = {r.name for r in default_rules()}
    for finding, sup in result.suppressed:
        assert finding.rule in known
        assert sup.reason and len(sup.reason) > 10, (
            f"{sup.path}:{sup.line} suppression lacks a real reason")


def test_port_concurrency_maps_are_guarded():
    """The schedulers' and the service's shared maps carry ``guarded-by``
    annotations, so the lint checks every access to them."""
    path = os.path.join(REPO, "src", "repro_torch", "core", "service.py")
    with open(path) as f:
        src = f.read()
    for attr in ("_streams", "_tenant_locks", "_queues", "_threads",
                 "_waiting", "_waiting_count", "_running", "_vtime",
                 "_admission_order", "_workers"):
        assert f"self.{attr}:" in src and any(
            line.strip().startswith(f"self.{attr}:")
            and "# guarded-by: " in line for line in src.splitlines()), attr
