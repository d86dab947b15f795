"""Training resilience: the non-finite sentinel (``sentinel.py``),
bounded retry with backoff (``retry.py``), durable state
(``durable.py``: atomic writes, checkpoint directories, the
asynchronous writer, preemption at dispatch boundaries, the data
cursor, the file commit protocol), the divergence watchdog
(``watchdog.py``) and the training fault injectors (``chaos.py``)."""

from deeplearning4j_tpu_torch.resilience.chaos import (  # noqa: F401
    ChaosIterator, FaultBurstInjector, InjectedFault, LatencyIterator,
    NaNPoisonIterator, PreemptionIterator, ProcessKillInjector,
    RaiseOnBatch, SimulatedPreemption, fire)
from deeplearning4j_tpu_torch.resilience.durable import (  # noqa: F401
    AsyncCheckpointWriter, CheckpointError, CommitTimeoutError,
    CorruptCheckpointError, PreemptionExit, PreemptionGuard,
    atomic_replace_path, atomic_write_bytes, atomic_write_json,
    atomic_write_text, capture_cursor_pass, commit_marker_path,
    consume_restored_cursor, declare_checkpoint_series, dispatch_boundary,
    latest_committed_step, list_committed_steps, publish_commit,
    read_commit, read_state_dir, shard_dir_name, sweep_tmp_dirs,
    verify_state_dir, wait_commit, write_checkpoint_dir, write_shard)
from deeplearning4j_tpu_torch.resilience.watchdog import (  # noqa: F401
    DivergenceError, DivergenceWatchdog)
