"""Every module of the JAX package has a module at the same path in the
port, and every public name the JAX module defines at top level (a
function, a class or an assignment, its name without a leading
underscore) is a name of the port's module: defined there or imported
into it. The names are read from the sources by ``ast``; nothing is
imported, so this test holds without JAX. The allow-list holds the names
that are TPU-only by what they compute."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "low_light_image_enhancement_tpu"
PORT_PKG = ROOT / "low_light_image_enhancement_tpu_torch"

# module (relative path) -> names the port has no counterpart of, and why
TPU_ONLY = {
    # the batch bands at which conv_impl="auto" picks packed on a TPU,
    # measured on a v5e; the port's auto is xla
    "blocks.py": {"AUTO_CONV_BANDS"},
    # pltpu.roll, and the VMEM planners of the TPU kernels' stripes
    "kernels/fused_enhance.py": {"kroll2d", "curve_plan_bytes_per_px",
                                 "guided_tail_bytes_per_px",
                                 "retinex_plan_bytes_per_px"},
    # VMEM stripes: the kernels of the port tile in 2-D with their own
    # halos, and only the canvas geometry carries over (CanvasPlan)
    "kernels/striping.py": {"StripePlan", "plan_stripes", "extract_stripes",
                            "merge_stripes", "stripe_pallas_call",
                            "stripe_pallas_call_windowed", "use_windowed",
                            "windows_aligned"},
    # a v5e's rates
    "utils/roofline.py": {"V5E_HBM_GBPS", "V5E_MXU_BF16_TFLOPS",
                          "V5E_VPU_TFLOPS_MEAS"},
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _defined(tree: ast.Module) -> set:
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
    return out


def _imported(tree: ast.Module) -> set:
    return {(a.asname or a.name).split(".")[0] for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for a in node.names}


def public_names(path: Path) -> set:
    """The JAX module's public names: what it defines at top level without
    a leading underscore."""
    return {n for n in _defined(_tree(path)) if not n.startswith("_")}


def port_names(path: Path) -> set:
    """What a caller can take from the port's module: every top-level
    definition and import."""
    tree = _tree(path)
    return _defined(tree) | _imported(tree)


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_jax_module_has_a_port_module():
    missing = [m for m in MODULES if not (PORT_PKG / m).is_file()]
    assert not missing, missing
    assert "pipeline.py" in MODULES and len(MODULES) > 40


@pytest.mark.parametrize("module", MODULES)
def test_module_names_have_counterparts(module):
    port = PORT_PKG / module
    assert port.is_file(), f"no port module {port}"
    allowed = TPU_ONLY.get(module, set())
    gap = public_names(JAX_PKG / module) - port_names(port) - allowed
    assert not gap, f"{module}: no counterpart in the port of {sorted(gap)}"
    # the allow-list holds names the JAX module has and the port lacks
    assert allowed <= public_names(JAX_PKG / module), module
    assert not allowed & port_names(port), module


def test_allow_list_names_real_modules():
    assert set(TPU_ONLY) <= set(MODULES)
