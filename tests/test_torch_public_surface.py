"""Every export of the JAX package resolves on the port.

The JAX package's ``__init__.py`` files are parsed with ``ast`` (not
imported): each name in a package's ``__all__``, and each name of the root
package's ``_LAZY`` table, must resolve as an attribute of the port's
matching package. The only names allowed to be absent are the JAX-only
ones in ``JAX_ONLY``, each with its reason (``JAX_ONLY_FUNCTIONS`` and
``JAX_ONLY_MODULES`` list the module-level names and modules without a
port counterpart); a JAX-only name the port grows
fails too, so the table stays true.
"""

import ast
import importlib
from pathlib import Path

import pytest

REF = Path(__file__).resolve().parent.parent / "spark_bam_tpu"

#: (package, name) → why the port has no such export.
JAX_ONLY = {
    ("spark_bam_tpu.tpu", "make_check_window"):
        "a jit factory: the port's check_window is eager PyTorch over the "
        "CUDA kernels, with nothing to compile per shape",
}

#: Modules of the JAX package with no port counterpart, each with its
#: reason (none of them is a package export).
JAX_ONLY_MODULES = {
    "spark_bam_tpu.analysis.rules.jit_purity":
        "guards JAX tracing; the port traces nothing",
    "spark_bam_tpu.core.platform":
        "the JAX compile cache, backend probe and forced CPU devices; the "
        "port's kernels are cached by source hash in kernels/build.py",
}


_JIT = ("a jit factory: the port runs the same program eagerly over the "
        "CUDA kernels (on the card a CUDA graph where the reference reuses "
        "a compiled program), so there is nothing to compile per shape")

#: Module-level functions of the JAX package that the port does not
#: define, each with its reason.
JAX_ONLY_FUNCTIONS = {
    ("spark_bam_tpu.tpu.checker", "make_check_window"): _JIT,
    ("spark_bam_tpu.tpu.checker", "make_count_window"): _JIT,
    ("spark_bam_tpu.tpu.checker", "make_count_window_raw"): _JIT,
    ("spark_bam_tpu.tpu.checker", "make_count_window_tokens"): _JIT,
    ("spark_bam_tpu.agg.kernels", "make_shard_map_agg_step"):
        "a shard_map program; the port's is parallel/mesh.py::"
        "make_shard_map_agg_step (an AggStep over torch.distributed), "
        "which the agg package exports",
    ("spark_bam_tpu.tpu.tokenize_device", "tokenize_planes"):
        "the JAX form of the device tokenizer; the port's is the CUDA "
        "kernel csrc/tokenize.cu with tokenize_device.tokenize_plain as "
        "its plain version",
}


def _exports(init: Path) -> list[str]:
    tree = ast.parse(init.read_text())
    names: list[str] = []
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if not isinstance(target, ast.Name):
                continue
            if target.id == "__all__":
                names += [ast.literal_eval(e) for e in node.value.elts]
            elif target.id == "_LAZY":
                names += _lazy_keys(node.value)
    return names


def _lazy_keys(node) -> list[str]:
    """The keys of the root ``_LAZY`` dict literal, its ``**{name: ...
    for name in (...)}`` comprehensions included."""
    keys = []
    for k, v in zip(node.keys, node.values):
        if k is not None:
            keys.append(ast.literal_eval(k))
        elif isinstance(v, ast.DictComp):
            keys += list(ast.literal_eval(v.generators[0].iter))
    return keys


def _packages() -> list[tuple[str, list[str]]]:
    out = []
    for init in sorted(REF.rglob("__init__.py")):
        rel = init.parent.relative_to(REF.parent)
        names = _exports(init)
        if names:
            out.append((".".join(rel.parts), names))
    return out


PACKAGES = _packages()


def test_the_reference_exports_were_found():
    pkgs = dict(PACKAGES)
    assert len(pkgs) >= 15
    assert {"load_bam", "load_reads", "load_sam", "load_bam_intervals",
            "load_splits_and_reads", "load_reads_and_positions",
            "default_config"} <= set(pkgs["spark_bam_tpu"])
    assert "BlockStream" in pkgs["spark_bam_tpu.bgzf"]


@pytest.mark.parametrize("package,names", PACKAGES,
                         ids=[p for p, _ in PACKAGES])
def test_every_export_resolves_on_the_port(package, names):
    port_name = package.replace("spark_bam_tpu", "spark_bam_tpu_torch", 1)
    port = importlib.import_module(port_name)
    missing = [n for n in names if not hasattr(port, n)
               and (package, n) not in JAX_ONLY]
    assert not missing, f"{port_name} lacks {missing}"
    grown = [n for n in names if (package, n) in JAX_ONLY
             and hasattr(port, n)]
    assert not grown, f"{port_name} has {grown}: drop them from JAX_ONLY"


def test_jax_only_entries_name_real_exports():
    pkgs = dict(PACKAGES)
    for package, name in JAX_ONLY:
        assert name in pkgs[package], (package, name)
    for module in JAX_ONLY_MODULES:
        path = REF.parent / (module.replace(".", "/") + ".py")
        assert path.exists(), module


def test_root_loaders_are_bound_lazily_and_are_the_load_apis():
    import spark_bam_tpu_torch as port
    from spark_bam_tpu_torch.load import api

    assert set(port._LAZY) == {
        "load_bam", "load_reads", "load_sam", "load_bam_intervals",
        "load_splits_and_reads", "load_reads_and_positions"}
    for name in port._LAZY:
        assert getattr(port, name) is getattr(api, name)
    assert hasattr(port, "load_bam")
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        port.nope  # noqa: B018


def test_module_level_names_of_the_issue_exist():
    """Names outside any ``__all__`` that the reference's docs call."""
    from spark_bam_tpu_torch.bam import header
    from spark_bam_tpu_torch.check import flags
    from spark_bam_tpu_torch.core import config, pos
    from spark_bam_tpu_torch.load import splits
    from spark_bam_tpu_torch.sbi import store
    from spark_bam_tpu_torch.tpu import checker, stream_check

    for mod, names in ((header, ("ContigLengths", "contig_lengths")),
                       (flags, ("Counts", "flags_fields")),
                       (pos, ("parse_pos",)),
                       (config, ("default_config",)),
                       (splits, ("set_locality_provider", "preferred_hosts")),
                       (store, ("shared_store", "reset_shared_store")),
                       (stream_check, ("stream_verdicts",
                                       "count_reads_streaming")),
                       (checker, ("count_repeat", "make_count_repeat"))):
        for name in names:
            assert callable(getattr(mod, name)), (mod.__name__, name)


def _defined(path: Path) -> set[str]:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_jax_only_functions_are_the_references_and_absent_here():
    for (module, name), reason in JAX_ONLY_FUNCTIONS.items():
        ref = REF.parent / (module.replace(".", "/") + ".py")
        assert name in _defined(ref), (module, name)
        port = importlib.import_module(
            module.replace("spark_bam_tpu", "spark_bam_tpu_torch", 1))
        assert not hasattr(port, name), f"{port.__name__}.{name}: {reason}"
