"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``."""
import ast
import pathlib

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_modules_were_found():
    names = {p.name for p in FILES}
    assert {"operators.py", "runtime.py", "mllm.py", "bridge.py",
            "fused.py", "superopt.py", "signature.py", "detector.py",
            "model.py", "ssm.py", "engine.py", "sampler.py", "serve.py",
            "gemma2_2b.py", "mamba2_130m.py", "utils.py", "quantize.py",
            "chatglm3_6b.py", "glm4_9b.py", "phi3_mini_3_8b.py",
            "multiquery.py", "gate.py", "cache.py", "admission.py",
            "tracer.py", "metrics.py", "slo.py", "report.py", "audit.py",
            "injector.py", "breaker.py", "chip_smoke.py",
            "sharing_tree.py", "extract_server.py", "multistream.py",
            "fleet.py", "optimizer.py", "checkpoint.py", "data.py",
            "trainer.py", "train.py", "pretrain.py"} <= names
    kernels = {p.parent.name for p in FILES if p.name == "kernel.py"}
    assert {"decode_attention", "ssd_scan", "flash_attention",
            "int8_matmul"} <= kernels
