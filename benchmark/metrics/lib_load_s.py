"""Seconds the program's first load of its CUDA library took in this
process (ops/cuda_lib.py `LOAD`: the sources' hash, finding or building
the library, dlopen), part of set-up; whether it built goes to stderr.
None where the program keeps no such counter or loaded no library."""

from benchmark import harness


def read(run):
    try:
        from gof_tpu_torch.ops import cuda_lib
    except ImportError:
        return None
    load = getattr(cuda_lib, "LOAD", None)
    if not load or load.get("seconds") is None:
        return None
    harness.log(f"kernel library: loaded in {load['seconds']:.3f} s, built: {load['built']}")
    return load["seconds"]
