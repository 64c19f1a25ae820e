"""Per-leaf init seeds derived with builtin ``hash()``.  ``str.__hash__``
is salted per process (PYTHONHASHSEED), so two processes initialising
"the same" model from the same seed get different per-leaf generators;
``models/params.py`` uses ``zlib.crc32`` for exactly this reason."""
import torch


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def init_params_buggy(schema, seed: int):
    out = {}
    for path, shape in schema.items():
        gen = torch.Generator().manual_seed(
            seed + (hash(_path_str(path)) & 0x7FFFFFFF))  # EXPECT: no-builtin-hash-persistence
        out[path] = torch.randn(shape, generator=gen)
    return out
