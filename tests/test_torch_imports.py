"""The port stands alone: no module of ``moss_speech_decoder_cosy_torch``,
not ``chip_smoke.py`` and not the card's tests (``test_torch_cuda.py``)
import jax, flax or the JAX package (AST scan)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "moss_speech_decoder_cosy_tpu")
FILES = sorted(str(p.relative_to(ROOT)) for p in
               (ROOT / "moss_speech_decoder_cosy_torch").rglob("*.py")) + [
    "chip_smoke.py", "tests/test_torch_cuda.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_imports(rel):
    bad = [m for m in _imported(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 15
    for mod in ("ops/flash_attention.py", "ops/fused_block.py",
                "models/flow/kv_stream.py", "pipeline/kv_session.py",
                "pipeline/bulk_voc.py", "pipeline/kv_batcher.py",
                "pipeline/device_session.py", "serving/audio_batcher.py",
                "serving/session_manager.py", "utils/flops.py",
                "utils/graphs.py",
                "tokenizer/model.py", "tokenizer/features.py",
                "tokenizer/config.py", "ops/melspec.py",
                "models/campplus.py", "codec.py", "eval/audio_io.py",
                "native/__init__.py", "serving/protocol.py",
                "serving/opus.py", "serving/ogg.py",
                "serving/audio_process.py", "serving/ws_server.py",
                "serving/web_demo.py", "serving/boot.py",
                "utils/checkpoint.py", "utils/onnx_io.py",
                "utils/ref_config.py", "model_dir.py", "bin/inference.py",
                "bin/serve.py", "bin/decode_server.py",
                "models/llm/qwen2.py", "models/llm/speech_lm.py",
                "models/llm/transformer_lm.py", "serving/lm_server.py",
                "serving/token_server.py", "synthesizer.py", "frontend.py",
                "models/flow/flow_v1.py", "models/flow/dit.py",
                "models/flow/vdiff.py", "pipeline/stream_v1.py",
                "tokenizer/asr_decoder.py", "eval/rtf.py", "eval/score.py",
                "eval/benchmark.py", "data/dataset.py", "data/processor.py",
                "data/tar.py", "bin/benchmark.py", "bin/score.py",
                "bin/validate_reference.py", "bin/tools.py"):
        assert f"moss_speech_decoder_cosy_torch/{mod}" in FILES, mod


def test_the_asr_eval_and_data_modules_load_no_jax():
    """Imported in a fresh interpreter, the ASR head, the eval harness, the
    data pipeline and their CLIs leave jax, flax and the JAX package out of
    ``sys.modules`` (the AST scan misses an import made indirectly)."""
    import subprocess
    import sys
    mods = ["tokenizer.asr_decoder", "eval", "eval.rtf", "eval.score",
            "eval.benchmark", "data", "data.processor", "data.tar",
            "bin.benchmark", "bin.score", "bin.validate_reference",
            "bin.tools"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('moss_speech_decoder_cosy_torch.' + m)"
            "\n"
            f"print(sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip().splitlines()[-1] == "[]", out
