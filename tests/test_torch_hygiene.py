"""What the port may import and where it builds: an AST walk over
`src/repro_torch/**/*.py` and `chip_smoke.py` (no `jax`, no `repro` and no
`ml_dtypes`, which the card's machine lacks, anywhere; no `triton` at module
level; no library attention or `torch.compile`, except
the smoke script's one timed yardstick), the kernel sources the build names,
the build directory in `.gitignore`, and the notes every CUDA source opens
with; and the trainer's entry points default to the card and raise
without one."""
import ast
import pathlib
import re

import pytest

pytestmark = pytest.mark.tier1

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_ANYWHERE = {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}
FORBIDDEN_AT_MODULE_LEVEL = {"triton"}


def _imports(tree, module_level_only):
    nodes = tree.body if module_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def test_the_walk_sees_the_whole_package():
    names = {f.relative_to(ROOT).as_posix() for f in FILES}
    for want in ("src/repro_torch/launch/engine.py", "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/models/layers.py", "src/repro_torch/convert.py",
                 "src/repro_torch/launch/train.py", "src/repro_torch/checkpoint/manager.py",
                 "src/repro_torch/data/pipeline.py", "chip_smoke.py",
                 "src/repro_torch/configs/phi3_5_moe.py",
                 "src/repro_torch/configs/llama4_scout.py",
                 "src/repro_torch/models/slot_state.py",
                 "src/repro_torch/models/linear_attn.py",
                 "src/repro_torch/models/rwkv6.py", "src/repro_torch/models/gla.py",
                 "src/repro_torch/models/zamba2.py",
                 "src/repro_torch/configs/rwkv6_1_6b.py",
                 "src/repro_torch/configs/gla_1_3b.py",
                 "src/repro_torch/configs/zamba2_1_2b.py",
                 "src/repro_torch/configs/whisper_large_v3.py"):
        assert want in names
    assert len(FILES) >= 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(m, ln) for m, ln in _imports(tree, False) if m in FORBIDDEN_ANYWHERE]
    assert not bad, (f"{path}: imports {bad}; the port imports nothing of JAX, of `repro` "
                     f"or `ml_dtypes`")
    bad = [(m, ln) for m, ln in _imports(tree, True) if m in FORBIDDEN_AT_MODULE_LEVEL]
    assert not bad, f"{path}: module-level import of {bad}; import it where it is launched"
    text = path.read_text()
    assert not re.search(r"import_module\(\s*['\"](jax|repro)\b", text)
    assert "torch.compile" not in text
    if path.name == "chip_smoke.py":
        # the library attention is timed beside B8 / B9 as a yardstick, in one
        # function, and computes nothing the script checks or serves
        text = text.replace(ast.get_source_segment(text, next(
            n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name == "_sdpa_yardstick_ms")), "")
    assert "scaled_dot_product_attention" not in text


def test_kernel_sources_exist_and_say_what_they_replace():
    from repro_torch.kernels import _build
    assert _build.SOURCES and _build.HEADERS
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file(), name
    on_disk = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert on_disk == set(_build.SOURCES + _build.HEADERS), "a source the build does not name"
    for name, pallas in (("lut_gemv.cu", "lut_matmul_fused_gemv"),
                         ("lut_gemm.cu", "lut_matmul_fused"),
                         ("lut_multi_gemv.cu", "lut_matmul_fused_multi_gemv"),
                         ("lut_multi_gemm.cu", "lut_matmul_fused_multi"),
                         ("paged_attention.cu", "paged_pool_attention"),
                         ("lut_plain.cu", "lut_matmul_f32"),
                         ("lut_plain.cu", "lut_matmul_int8"),
                         ("smooth_quant.cu", "smooth_quant"),
                         ("paged_dequant.cu", "paged_dequant_attention"),
                         ("flash_attention.cu", "flash_attention")):
        head = (_build.CSRC / name).read_text()[:2500]
        assert f"`{pallas}`" in head and "Replaces the Pallas TPU kernel" in head
        assert "What bounds it" in head
        assert "torch/extension.h" not in (_build.CSRC / name).read_text()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_backward_source_says_it_replaces_no_tpu_kernel_and_uses_no_atomics():
    """lut_backward.cu opens with its note (it replaces no Pallas kernel, and
    what bounds it), sums without atomics, and the differentiable route in
    kernels/ops.py calls no scatter / index-add and no dense matmul."""
    from repro_torch.kernels import _build
    text = (_build.CSRC / "lut_backward.cu").read_text()
    assert "Replaces no TPU kernel" in text[:2500] and "What bounds it" in text[:2500]
    assert "atomicAdd" not in text and "torch/extension.h" not in text
    ops_text = (PKG / "kernels" / "ops.py").read_text()
    for call in ("scatter_add", "index_add", "torch.matmul", "clustered_dequant"):
        assert call not in ops_text, call


def test_build_directory_is_ignored_and_keyed_by_the_sources():
    from repro_torch.kernels import _build
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert _build.BUILD_ROOT == ROOT / "build" / "repro_torch_kernels"
    assert re.fullmatch(r"[0-9a-f]{16}", _build._source_hash())


def test_import_builds_nothing():
    import repro_torch.core.api  # noqa: F401
    import repro_torch.models.registry  # noqa: F401  (every family's module)
    import repro_torch.core.smoothing  # noqa: F401
    import repro_torch.kernels.lut_matmul  # noqa: F401
    import repro_torch.kernels.paged_attention  # noqa: F401
    import repro_torch.kernels.smooth_quant  # noqa: F401
    import repro_torch.kernels.autotune  # noqa: F401
    import repro_torch.kernels.flash_attention  # noqa: F401
    from repro_torch.kernels import _build
    assert _build._lib is None, "the library must load at the first launch, not at import"


PTXAS_SAMPLE = """\
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__852f60fc_11_lut_gemv_cu_1eac3cc415lut_gemv_kernelILi4EfLb0EEEvPKT0_PKfPKhS5_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__852f60fc_11_lut_gemv_cu_1eac3cc415lut_gemv_kernelILi4EfLb0EEEvPKT0_PKfPKhS5_Pfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers, 16448 bytes smem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__852f60fc_11_lut_gemv_cu_1eac3cc415lut_gemv_kernelILi2EfLb1EEEvPKT0_PKfPKhS5_Pfiiiii' for 'sm_90a'
    24 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 104 registers, used 1 barriers, 16448 bytes smem
ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__0_17_paged_attention_cu_2916paged_attn_kernelI6__halfEEvv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 0 bytes smem
"""


def test_resource_usage_reads_the_ptxas_reports(tmp_path):
    from repro_torch.kernels import _build
    assert ("-Xptxas", "-v") == tuple(_build.NVCC_FLAGS[-2:])
    (tmp_path / "lut_gemv.ptxas.txt").write_text(PTXAS_SAMPLE)
    assert _build.resource_usage(tmp_path) == {
        "lut_gemv_kernel": {"registers": [104, 106], "stack_bytes": 24, "spill_bytes": 12},
        "paged_attn_kernel": {"registers": [40, 40], "stack_bytes": 0, "spill_bytes": 0}}
    assert _build.resource_usage(tmp_path / "none") == {}


def test_trainer_entry_points_default_to_cuda_and_raise_without_one():
    import torch

    from repro_torch.launch import train as port_train
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card; the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="pass device='cpu' explicitly"):
        port_train.train("qwen2-1.5b", steps=1)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"])
