"""repro_torch.analysis: the port's static and runtime contract checker,
the twin of `repro.analysis`, run as a CI gate.

The port's correctness rests on invariants that are otherwise prose: the
dispatch rule ("no hot-path module computes affinity, distance or LSH keys
outside `repro_torch/kernels`"), the padded-tail masking contract every
kernel honors, the shared memory a launch may ask of an sm_90 block, and
the lock / device-transfer discipline of the threaded serving and pipeline
layers. Three passes, one CLI:

  contracts    ref-vs-kernel output shapes and dtypes per op on the card,
               each kernel's shared bytes at the contract cases and the
               main path's full-width shapes against 232,448 bytes, and
               NaN/Inf poisoning of every kernel's pad region asserting
               valid-slot outputs bit-unchanged
               (repro_torch.analysis.contracts)
  dispatch     AST lint over src/repro_torch and examples/torch_*.py
               forbidding private compute: torch.matmul / einsum / dot,
               norms and (a - b) ** 2 distance expansions, hand-rolled LSH
               hashing outside repro_torch/kernels/
               (repro_torch.analysis.dispatch)
  concurrency  lock discipline in serve/batching.py, serve/live.py,
               core/pipeline.py, core/online.py: device transfers or Future
               callbacks under a lock, shared counters mutated off-lock,
               inconsistent lock order; tree-wide, joins without a timeout
               and retry loops without backoff
               (repro_torch.analysis.concurrency)

Run it:

    PYTHONPATH=src python -m repro_torch.analysis.check \\
        --report CHECK_report_torch.json        # on the card
    PYTHONPATH=src python -m repro_torch.analysis.check --device cpu
    python -m repro_torch.launch.run_palid --check   # the same, on the card

Escape hatch: a finding that is intentional carries a pragma ON its line or
the line above:

    # analysis: allow(rule-name): why this is safe here

The reason is REQUIRED; an empty reason is itself a violation
(`pragma-missing-reason`). Suppressed findings still appear in the JSON
report with their reasons, so the escape hatch is auditable.
"""

from repro_torch.analysis.report import Report, Violation  # noqa: F401
