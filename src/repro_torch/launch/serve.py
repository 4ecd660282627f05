"""Serving launcher: prefill + batched decode via ``repro_torch.serve``.

    python -m repro_torch.launch.serve --arch llama3.2-3b --shape decode_32k
    python -m repro_torch.launch.serve --arch lm-tiny --smoke --device cpu
    python -m repro_torch.launch.serve --arch gemma3-12b --smoke --device cpu

Flags: ``--arch`` (required: any arch of ``repro_torch.configs.ARCHS``;
gemma3-12b serves its sliding-window layers from rings), ``--shape`` (a
serving cell, default ``decode_32k``), ``--gen``, ``--smoke`` (CPU-scale
model, batch 2, prompt 32, cap 128) and ``--device``. Runs on the GPU
unless ``--device cpu`` is given. ``--mesh`` is refused: sharded serving is not ported yet.
"""
from __future__ import annotations

import sys


def main(argv=None):
    from repro_torch.api import serve
    from repro_torch.api.config import ConfigError, parse_cli, truthy

    flags = parse_cli(sys.argv[1:] if argv is None else argv)
    arch = flags.pop("arch", None)
    if arch is None:
        raise ConfigError("--arch is required")
    if "mesh" in flags:
        raise ConfigError("--mesh: sharded serving is the distributed "
                          "slice's work, not ported yet (the port serves on "
                          "one card)")
    shape = flags.pop("shape", "decode_32k")
    gen = int(flags.pop("gen", 32))
    smoke = truthy(flags.pop("smoke", False))
    device = flags.pop("device", None)
    if flags:
        raise ConfigError(f"unknown serve flags {sorted(flags)}")

    if smoke:
        return serve(arch, smoke=True, batch=2, prompt_len=32, cap=128,
                     gen=gen, log=print, device=device)
    return serve(arch, shape=shape, gen=gen, log=print, device=device)


if __name__ == "__main__":
    main()
