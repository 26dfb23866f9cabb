"""Small cells of both families for the benchmark's CPU tests: a copy of
the benchmark's root in a temporary directory, the manifest as it is, and
small configurations and cells added beside the real ones as files
alone, found by name as the real ones are."""
from pathlib import Path

HERE = Path(__file__).resolve().parent


TINY = {
    "qwen1.5-0.5b": dict(hidden_size=64, intermediate_size=128,
                         num_attention_heads=4, num_key_value_heads=2,
                         num_hidden_layers=2, vocab_size=256),
    "mamba2-370m": dict(d_model=64, n_layer=2, vocab_size=250),
}
TINY_ASSUMED = {"qwen1.5-0.5b": {"head_dim": 16}, "mamba2-370m": {}}
TINY_SSM = {"d_state": 16, "headdim": 16, "chunk_size": 16}
TINY_TRAFFIC = dict(clients=2, batch=2, seq_len=40, num_seqs=16, syn_seq=4,
                    label_rank=2)


def make_tiny_bench(root: Path, dtype: str = "float32",
                    limits_from: str = "") -> Path:
    """A benchmark root under ``root`` holding the real files, the
    manifest as it is, and the cells ``tiny.<config>`` (both families at
    small widths, ``dtype`` compute), added as files alone; their limits
    are the real cell ``limits_from``'s, or loose ones."""
    import json
    import shutil
    bench = root / "fl_bench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py", "conftest.py"))
    traffic = json.loads((HERE / "traffic" / "fl3sfc.t4096.json")
                         .read_text())
    traffic.update(TINY_TRAFFIC)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    limits = {"loss": 1.0, "ef": 1.0}
    if limits_from:
        limits = json.loads((HERE / "cells" / f"{limits_from}.json")
                            .read_text())["limits"]
    for name, widths in TINY.items():
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg.update(widths)
        cfg["assumed"].update(TINY_ASSUMED[name], compute_dtype=dtype)
        if "ssm_defaults" in cfg:
            cfg["ssm_defaults"].update(TINY_SSM)
        (bench / "configs" / f"tiny.{name}.json").write_text(json.dumps(cfg))
        cell = {"config": f"tiny.{name}", "traffic": "tiny", "chips": 1,
                "why": "small widths on the CPU", "limits": limits}
        (bench / "cells" / f"tiny.{name}.json").write_text(json.dumps(cell))
    shutil.copy(HERE.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return bench
