"""Dispatch lint: machine-checks the port's rule that
`repro_torch.kernels.ops` is the ONLY compute backend: no module outside
`repro_torch/kernels/` computes affinity, pairwise distance or LSH bucket
keys privately (the twin of `repro.analysis.dispatch`, with torch's call
names).

Rules
-----
private-matmul     direct torch.matmul / mm / bmm / einsum / tensordot /
                   inner / dot / vdot calls, and numpy's, in the
                   clustering stack (src/repro_torch/core, lsh, serve and
                   the port's examples). The model stack (models/, train/)
                   legitimately contracts activations and is out of scope.
                   The `@` operator is not a call and is not flagged, as
                   in the JAX lint.
private-distance   hand-rolled pairwise distance anywhere in scope:
                   torch.cdist, torch.norm, torch.linalg.norm /
                   vector_norm, F.pairwise_distance, numpy's norm, scipy's
                   cdist / pdist, or the sum((a - b) ** 2) expansion inside
                   a torch.sum / np.sum call.
private-lsh        hand-rolled LSH hashing anywhere in scope: the FNV /
                   golden-ratio mix constants (0x811C9DC5 / 0x9E3779B1) or
                   a floor(x / seg) quantization via torch.floor /
                   np.floor of a division.

`repro_torch/kernels/` (the plain versions in ref.py and the kernels'
plans) is the sanctioned implementation and is excluded wholesale;
everything else needs an `# analysis: allow(rule): reason` pragma to keep
such code.
"""

from __future__ import annotations

import ast

from repro_torch.analysis import astutil
from repro_torch.analysis.pragmas import PragmaIndex
from repro_torch.analysis.report import Report, Violation

PASS = "dispatch"

# private-matmul applies to the clustering stack only (see module docstring)
MATMUL_SCOPES = ("src/repro_torch/core", "src/repro_torch/lsh",
                 "src/repro_torch/serve", "examples")

MATMUL_CALLS = frozenset(
    f"torch.{fn}" for fn in ("matmul", "mm", "bmm", "einsum", "tensordot",
                             "inner", "dot", "vdot")
) | frozenset(
    f"numpy.{fn}" for fn in ("dot", "matmul", "einsum", "tensordot",
                             "inner", "vdot"))

NORM_CALLS = frozenset((
    "torch.cdist", "torch.norm", "torch.linalg.norm",
    "torch.linalg.vector_norm", "torch.nn.functional.pairwise_distance",
    "numpy.linalg.norm", "scipy.spatial.distance.cdist",
    "scipy.spatial.distance.pdist",
))

SUM_CALLS = frozenset(("torch.sum", "numpy.sum"))
FLOOR_CALLS = frozenset(("torch.floor", "numpy.floor"))

# the multiply-xor fold constants of the kernel's bucket hash: presence
# outside repro_torch/kernels/ means someone re-rolled the hash
LSH_MIX_CONSTANTS = frozenset((0x811C9DC5, 0x9E3779B1))


def _contains_sub_square(node: ast.AST) -> bool:
    """True if the tree contains `(a - b) ** 2` or `(a - b) * (a - b)`,
    the pairwise-distance expansion."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.BinOp):
            continue
        if isinstance(sub.op, ast.Pow):
            if (isinstance(sub.left, ast.BinOp)
                    and isinstance(sub.left.op, ast.Sub)
                    and isinstance(sub.right, ast.Constant)
                    and sub.right.value == 2):
                return True
        if isinstance(sub.op, ast.Mult):
            if (isinstance(sub.left, ast.BinOp)
                    and isinstance(sub.left.op, ast.Sub)
                    and isinstance(sub.right, ast.BinOp)
                    and isinstance(sub.right.op, ast.Sub)
                    and ast.dump(sub.left) == ast.dump(sub.right)):
                return True
    return False


def check_source(rel: str, src: str, tree: ast.AST,
                 pragmas: PragmaIndex) -> list[Violation]:
    imports = astutil.ImportTable(tree)
    out: list[Violation] = []
    in_matmul_scope = any(rel.startswith(p) for p in MATMUL_SCOPES)

    def emit(rule: str, line: int, msg: str) -> None:
        out.append(pragmas.apply(Violation(PASS, rule, rel, line, msg)))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            full = astutil.call_full_name(node, imports)
            if full in MATMUL_CALLS and in_matmul_scope:
                emit("private-matmul", node.lineno,
                     f"direct {full} in the clustering stack: route "
                     "through repro_torch.kernels.ops (affinity / "
                     "affinity_matvec / assign_clusters / "
                     "pairwise_distance)")
            if full in NORM_CALLS:
                emit("private-distance", node.lineno,
                     f"{full}: pairwise distances must come from "
                     "repro_torch.kernels.ops.pairwise_distance (ONE "
                     "contraction, bit-identical across engines)")
            if full in SUM_CALLS and any(
                    _contains_sub_square(a) for a in node.args):
                emit("private-distance", node.lineno,
                     "sum((a - b) ** 2) distance expansion: use "
                     "repro_torch.kernels.ops.pairwise_distance instead")
            if full in FLOOR_CALLS and any(
                    isinstance(a, ast.BinOp) and isinstance(a.op, ast.Div)
                    for a in node.args):
                emit("private-lsh", node.lineno,
                     "floor(x / seg) bucket quantization: LSH keys must "
                     "come from repro_torch.kernels.ops.lsh_hash (key "
                     "identity across store builds depends on it)")
        elif (isinstance(node, ast.Constant) and type(node.value) is int
              and node.value in LSH_MIX_CONSTANTS):
            emit("private-lsh", node.lineno,
                 f"LSH mix constant 0x{node.value:X} outside "
                 "repro_torch/kernels/: hand-rolled bucket hashing breaks "
                 "cross-backend key parity")
    return out


def run(root: str, report: Report, pragma_cache) -> None:
    n_files = 0
    for rel in astutil.iter_source_files(root):
        try:
            src, tree = astutil.parse_file(root, rel)
        except SyntaxError as e:
            report.add(Violation(PASS, "syntax-error", rel,
                                 e.lineno or 0, str(e)))
            continue
        n_files += 1
        pragmas = pragma_cache.get(rel, src)
        report.extend(check_source(rel, src, tree, pragmas))
    report.note(PASS, files_scanned=n_files)
