"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package,
compared by whole top-level module names (the port's name begins with the
JAX package's), and nothing under reference/ imports the port."""

import ast
import os
import subprocess
import sys

from portbench import spec

REF = os.path.join(spec.BENCH_DIR, "reference")

PROBE = """
import sys
sys.path.insert(0, {root!r})
import portbench.harness, portbench.reference.encoder, portbench.reference.mpt, portbench.reference.rank
import portbench.reference.text, portbench.control, portbench.sweep
from portbench import spec
for kind in ("drivers", "metrics"):
    for f in sorted(__import__("os").listdir(__import__("os").path.join(spec.BENCH_DIR, kind))):
        if f.endswith(".py"):
            spec.load_module(kind, f[:-3])
import vietnamese_qa_system_tpu_torch.engine.continuous, vietnamese_qa_system_tpu_torch.engine.query
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
"""


def test_no_jax_in_the_harness_process():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=spec.ROOT)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "USE_FLAX": "0", "USE_JAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "vietnamese_qa_system_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vietnamese_qa_system_tpu"}


def test_harness_refuses_when_jax_was_loaded(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "vietnamese_qa_system_tpu.fake", object())
    assert "vietnamese_qa_system_tpu.fake" in harness.forbidden_modules()
    monkeypatch.delitem(sys.modules, "vietnamese_qa_system_tpu.fake")
    monkeypatch.setitem(sys.modules, "vietnamese_qa_system_tpu_torch_like", object())
    assert "vietnamese_qa_system_tpu_torch_like" not in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_port():
    for f in os.listdir(REF):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("vietnamese_qa_system_tpu_torch", "vietnamese_qa_system_tpu", "jax"), \
                    (f, n)
