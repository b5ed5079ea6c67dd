"""Layer 4: stdlib-``ast`` lints over ``src/repro_torch`` (the JAX
package's ``analysis/lint.py``).

Five rules, each a hot-path invariant that lives in source convention
rather than in any one run, so the op and kernel audits cannot see it:

  lint.cache-repeat     (JAX: lint.jnp-repeat) models/ + serving/ must not
                        call ``repeat_interleave``, nor ``.repeat`` /
                        ``.expand`` a KV-cache tensor (a receiver named
                        ``k``, ``v``, ``codes`` or ``*cache*``): on a cache
                        it materializes a (B, Hq, S, d)-class expansion;
                        the decode kernels take the R query heads of a kv
                        group as rows instead.
  lint.host-sync        models/, kernels/, core/ and serving/ must not call
                        ``.item()``, ``.tolist()``, ``.cpu()``,
                        ``.numpy()``, ``np.asarray`` or
                        ``torch.cuda.synchronize``: each is a device sync
                        (serving/engine.py, the host scheduler, syncs once
                        a decode chunk and once an admission by design and
                        is exempt; telemetry and chaos are not).
  lint.dispatch-routing models/ + serving/ must not read
                        REPRO_DISABLE_KERNELS (core/dispatch.py owns the
                        kill switch), call ``library()``, reach a C entry
                        point (``repro_*``) or import ``ctypes``: every
                        launch goes through a ``kernels/*/ops.py`` wrapper
                        that ``core/dispatch.py`` gates.
  lint.paged-gather     models/ + serving/ must not call ``gather_pages``:
                        decode reads the KV pool through the page table
                        (kernels 7 and 8); models/paged_fallback.py, the
                        gathered-view tier, is exempt.
  lint.kernel-wrapper   (JAX: lint.interpret-default) every public function
                        of a ``kernels/*/ops.py`` that reaches ``library()``
                        (itself, or through a module-local helper that is
                        not a counted wrapper) wears ``@cost.counted``, so
                        the dry run, the op audit and the liveness pass see
                        its calls, bytes and scratch.

JAX's ``interpret=None`` rule does not transfer: a CUDA wrapper has no
interpret mode (a CPU tensor takes the plain version).  Its pallas-import
half of ``lint.dispatch-routing`` becomes the ``library()`` / ``repro_*``
/ ``ctypes`` checks.

Exemptions are of two kinds, each with its reason: a whole file
(``EXEMPT``), or one rule in one function of one file (``EXEMPT_SITES``).
``lint_source`` lints one buffer (tests' violating fixtures); ``run_lint``
walks the tree.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.registry import Violation, audit

SRC_ROOT = Path(__file__).resolve().parents[1]          # .../src/repro_torch

KILL_SWITCH = "REPRO_DISABLE_KERNELS"
CACHE_NAMES = frozenset(("k", "v", "kv", "ck", "cv", "kc", "vc", "codes",
                         "k_pool", "v_pool", "codes_pool"))
SYNC_METHODS = frozenset(("item", "tolist", "cpu", "numpy"))


def _in(*dirs: str) -> Callable[[str], bool]:
    def applies(rel: str) -> bool:
        return any(rel.startswith(d + "/") for d in dirs)
    return applies


def _ops_module(rel: str) -> bool:
    parts = rel.split("/")
    return len(parts) == 3 and parts[0] == "kernels" and parts[2] == "ops.py"


def _is_name_attr(node: ast.AST, base: str, attr: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name) and node.value.id == base)


def _root_name(node: ast.AST) -> Optional[str]:
    """The variable an expression hangs off: ``cache["k"][0]`` ->
    "cache", ``v[None]`` -> "v", ``self.k.view(..)`` -> "k"."""
    while True:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr
            node = node.value
        else:
            return None


def _is_cache(node: ast.AST) -> bool:
    name = _root_name(node)
    return name is not None and (name in CACHE_NAMES or "cache" in name)


def _owner(tree: ast.AST, line: int) -> str:
    """The outermost function (a method, or a module-level def) whose
    lines hold ``line``."""
    best, span = "<module>", None
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.lineno <= line <= node.end_lineno
                and (span is None or node.end_lineno - node.lineno > span)):
            best, span = node.name, node.end_lineno - node.lineno
    return best


# ------------------------------------------------------------ rule bodies
def _check_cache_repeat(rel: str, tree: ast.AST) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr == "repeat_interleave":
            out.append(Violation(
                "lint.cache-repeat", f"{rel}:{node.lineno}",
                "repeat_interleave in models//serving/ — take the R query "
                "heads of a kv group as rows instead of expanding"))
        elif (isinstance(fn, ast.Attribute) and fn.attr in ("repeat",
                                                            "expand")
              and _is_cache(fn.value)):
            out.append(Violation(
                "lint.cache-repeat", f"{rel}:{node.lineno}",
                f".{fn.attr}() of a KV-cache tensor "
                f"({ast.unparse(fn.value)}) materializes an expanded "
                "cache"))
    return out


def _check_host_sync(rel: str, tree: ast.AST) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr in SYNC_METHODS
                and not node.args and not node.keywords):
            out.append(Violation(
                "lint.host-sync", f"{rel}:{node.lineno}",
                f".{fn.attr}() reads device data on the host (a sync) in a "
                "hot module"))
        elif (_is_name_attr(fn, "np", "asarray")
              or _is_name_attr(fn, "numpy", "asarray")):
            out.append(Violation(
                "lint.host-sync", f"{rel}:{node.lineno}",
                "np.asarray() of a tensor copies it to the host (a sync) "
                "in a hot module"))
        elif (isinstance(fn, ast.Attribute) and fn.attr == "synchronize"
              and isinstance(fn.value, ast.Attribute)
              and fn.value.attr == "cuda"):
            out.append(Violation(
                "lint.host-sync", f"{rel}:{node.lineno}",
                "torch.cuda.synchronize() in a hot module"))
    return out


def _check_dispatch_routing(rel: str, tree: ast.AST) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value == KILL_SWITCH:
            out.append(Violation(
                "lint.dispatch-routing", f"{rel}:{node.lineno}",
                f"reads {KILL_SWITCH} directly — the kill switch is owned "
                "by core/dispatch.py (kernels_disabled())"))
        elif isinstance(node, ast.Call) and (
                _is_name_attr(node.func, "kernels", "library")
                or (isinstance(node.func, ast.Name)
                    and node.func.id == "library")):
            out.append(Violation(
                "lint.dispatch-routing", f"{rel}:{node.lineno}",
                "calls the kernel library directly — launch through a "
                "kernels/*/ops.py wrapper gated by core/dispatch.py"))
        elif (isinstance(node, ast.Attribute)
              and node.attr.startswith("repro_")):
            out.append(Violation(
                "lint.dispatch-routing", f"{rel}:{node.lineno}",
                f"reaches the C entry point {node.attr} outside its "
                "kernels/*/ops.py wrapper"))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else [node.module or ""])
            if any(m.split(".")[0] == "ctypes" for m in mods):
                out.append(Violation(
                    "lint.dispatch-routing", f"{rel}:{node.lineno}",
                    "imports ctypes outside kernels/ — the kernel library "
                    "is bound in kernels/__init__.py alone"))
    return out


def _check_paged_gather(rel: str, tree: ast.AST) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if ((isinstance(fn, ast.Name) and fn.id == "gather_pages")
                or (isinstance(fn, ast.Attribute)
                    and fn.attr == "gather_pages")):
            out.append(Violation(
                "lint.paged-gather", f"{rel}:{node.lineno}",
                "gather_pages in models//serving/ — decode reads the KV "
                "pool through the page table; gathered views live only in "
                "models/paged_fallback.py"))
    return out


def _calls(fn: ast.AST) -> Tuple[bool, set]:
    """(calls library() directly, names of the plain functions it calls)."""
    direct, names = False, set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if (_is_name_attr(node.func, "kernels", "library")
                or (isinstance(node.func, ast.Name)
                    and node.func.id == "library")):
            direct = True
        elif isinstance(node.func, ast.Name):
            names.add(node.func.id)
    return direct, names


def _counted(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if (_is_name_attr(target, "cost", "counted")
                or (isinstance(target, ast.Name) and target.id == "counted")):
            return True
    return False


def _check_kernel_wrapper(rel: str, tree: ast.AST) -> List[Violation]:
    fns = {n.name: n for n in tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    info = {name: _calls(fn) for name, fn in fns.items()}
    reach = {name for name, (direct, _) in info.items() if direct}
    changed = True
    while changed:          # through module-local helpers that are not
        changed = False     # counted wrappers themselves
        for name, (_, callees) in info.items():
            if name in reach:
                continue
            if any(c in reach and not _counted(fns[c]) for c in callees):
                reach.add(name)
                changed = True
    out = []
    for name in sorted(reach):
        fn = fns[name]
        if not name.startswith("_") and not _counted(fn):
            out.append(Violation(
                "lint.kernel-wrapper", f"{rel}:{fn.lineno}",
                f"def {name} reaches library() without @cost.counted — its "
                "launches would be invisible to the dry run and the audits"))
    return out


RULES: List[Tuple[str, Callable[[str], bool],
                  Callable[[str, ast.AST], List[Violation]]]] = [
    ("lint.cache-repeat", _in("models", "serving"), _check_cache_repeat),
    ("lint.host-sync", _in("models", "kernels", "core", "serving"),
     _check_host_sync),
    ("lint.dispatch-routing", _in("models", "serving"),
     _check_dispatch_routing),
    ("lint.paged-gather", _in("models", "serving"), _check_paged_gather),
    ("lint.kernel-wrapper", _ops_module, _check_kernel_wrapper),
]

# Whole files, each with its reason.
EXEMPT: Dict[Tuple[str, str], str] = {
    ("lint.host-sync", "serving/engine.py"):
        "the host scheduler: it syncs once a decode chunk (_chunk_sync) and "
        "once an admission (_admit_sync) by design, and keeps numpy mirrors "
        "of the slot state (trace_guard holds it to that count)",
    ("lint.host-sync", "serving/chaos.py"):
        "the chaos harness reads the allocator between scheduling "
        "iterations to check its invariants; it is a test driver that "
        "nothing on a serving path calls",
    ("lint.paged-gather", "models/paged_fallback.py"):
        "the designated gathered-view tier of paged decode (the plain "
        "oracle, the kill switch, kv_paged_native='gather')",
}

# One rule in one function of one file, each with its reason.
EXEMPT_SITES: Dict[Tuple[str, str, str], str] = {
    ("lint.cache-repeat", "models/transformer.py", "init_caches"):
        "stacks one freshly zeroed per-layer cache into the units' stacked "
        "caches at engine start: an allocation of the cache itself, not a "
        "query-head expansion, and never on a step",
    ("lint.cache-repeat", "models/encdec.py", "init_dec_caches"):
        "the decoder's self caches stacked over its layers at start, as "
        "init_caches does",
    ("lint.cache-repeat", "models/attention.py", "decode_seq_split"):
        "the plain branch (REPRO_DISABLE_KERNELS=1) repeats the (B, S/n) "
        "bool validity mask to one row per kv group for the reference "
        "attention; the K/V caches are not expanded",
    ("lint.host-sync", "core/collectives.py", "mesh_axis"):
        "ranks.tolist() reads the DeviceMesh's rank tensor, which lives "
        "on the host, once per flattened axis when its groups are built",
    ("lint.host-sync", "core/params.py", "from_numpy_tree"):
        "np.asarray of a host (numpy or JAX) leaf while loading weights, "
        "before any step",
    ("lint.host-sync", "core/params.py", "from_numpy_state"):
        "np.asarray of a host step counter while loading a state",
    ("lint.host-sync", "serving/telemetry.py", "merge_ranks"):
        "np.asarray of counters already on the host: the chunk's one "
        "transfer (_chunk_sync) brought them",
}


def lint_source(source: str, rel: str) -> List[Violation]:
    """Lint one buffer as if it lived at ``rel`` (posix, repro_torch-
    relative, e.g. "models/foo.py").  Rule applicability follows the
    path."""
    tree = ast.parse(source, filename=rel)
    out: List[Violation] = []
    for rule_id, applies, check in RULES:
        if not applies(rel) or (rule_id, rel) in EXEMPT:
            continue
        for v in check(rel, tree):
            line = int(v.entry.rsplit(":", 1)[1])
            if (rule_id, rel, _owner(tree, line)) in EXEMPT_SITES:
                continue
            out.append(v)
    return out


def run_lint(root: Path = SRC_ROOT) -> List[Violation]:
    out: List[Violation] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        out.extend(lint_source(path.read_text(), rel))
    return out


@audit("lint")
def _lint_audit() -> List[Violation]:
    return run_lint()
