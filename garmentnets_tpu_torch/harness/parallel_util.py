"""Process-parallel map with per-item exception capture (the port's copy of
garmentnets_tpu/harness/parallel_util.py).

Parity with reference `common/parallel_util.py:36-74` (dask fork-based bag
replaced by a stdlib fork Pool + cloudpickle for closure support; same
error-capturing DataFrame contract: columns [result, error, stack_trace],
optional index preservation). Workers pin BLAS to one thread each
(reference eval.py:3-10) so P metric processes don't oversubscribe P cores.
A thread pool takes over where fork or cloudpickle is missing (metric
funcs are numpy/scipy and release the GIL for the heavy parts); the mode a
map runs in is printed once per process ("parallel_map: processes" or
"parallel_map: threads") and kept in `MODES`.

Fork after CUDA initialization is unsafe: call this from a process that
has not touched the card (the eval CLI is such a process).
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback

import pandas as pd

_BLAS_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
             "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS")
# pool modes this process has run a map in
MODES: set = set()


def pin_blas_threads():
    """Single-thread the BLAS/OpenMP pools (reference eval.py:3-10); only
    fully effective when called before numpy is first imported."""
    for var in _BLAS_ENV:
        os.environ[var] = "1"


def interpret_num_workers(num_workers: int) -> int:
    if num_workers < 1:
        return multiprocessing.cpu_count()
    return num_workers


def _safe_call(func, x):
    try:
        return {"result": func(x), "error": None, "stack_trace": None}
    except Exception as e:  # noqa: BLE001 — per-item capture is the contract
        return {"result": None, "error": e,
                "stack_trace": traceback.format_exc()}


# fork-pool worker state: the callable ships once via the initializer
# (cloudpickle handles closures over zarr groups; plain pickle does not)
_WORKER_FUNC = None


def _proc_init(payload: bytes):
    pin_blas_threads()
    global _WORKER_FUNC
    import cloudpickle
    _WORKER_FUNC = cloudpickle.loads(payload)


def _proc_call(x):
    out = _safe_call(_WORKER_FUNC, x)
    for key in ("result", "error"):
        try:
            pickle.dumps(out[key])
        except Exception:  # noqa: BLE001 — keep the row, degrade the payload
            out[key] = (None if key == "result"
                        else RuntimeError(repr(out[key])))
    return out


def _map_processes(func, items, num_workers):
    import cloudpickle
    ctx = multiprocessing.get_context("fork")
    payload = cloudpickle.dumps(func)
    with ctx.Pool(num_workers, initializer=_proc_init,
                  initargs=(payload,)) as pool:
        return pool.map(_proc_call, items)


def _map_threads(func, items, num_workers):
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return list(ex.map(lambda x: _safe_call(func, x), items))


def _cloudpickle_available() -> bool:
    try:
        import cloudpickle  # noqa: F401
        return True
    except ImportError:
        return False


def pool_mode(mode: str = "auto") -> str:
    """'processes' or 'threads': what `parallel_map(mode=mode)` runs a
    pool of more than one worker in."""
    use_procs = mode == "process" or (
        mode == "auto"
        and "fork" in multiprocessing.get_all_start_methods()
        and _cloudpickle_available())
    return "processes" if use_procs else "threads"


def _note_mode(name: str, num_workers: int) -> None:
    if name not in MODES:
        MODES.add(name)
        print(f"parallel_map: {name} ({num_workers} workers)", flush=True)


def parallel_map(func, sequence, num_workers: int = -1,
                 include_input: bool = False,
                 preserve_index: bool = True,
                 mode: str = "auto") -> pd.DataFrame:
    """mode: 'auto' (fork processes when available), 'process', 'thread'."""
    num_workers = interpret_num_workers(num_workers)
    input_sequence = list(sequence)

    if num_workers == 1 or len(input_sequence) <= 1:
        output = [_safe_call(func, x) for x in input_sequence]
    elif pool_mode(mode) == "processes":
        _note_mode("processes", num_workers)
        output = _map_processes(func, input_sequence, num_workers)
    else:
        _note_mode("threads", num_workers)
        output = _map_threads(func, input_sequence, num_workers)

    index = None
    if isinstance(sequence, pd.Series) and preserve_index:
        index = sequence.index
    df = pd.DataFrame(output, columns=["result", "error", "stack_trace"],
                      index=index)
    if include_input:
        df["input"] = input_sequence
    return df
