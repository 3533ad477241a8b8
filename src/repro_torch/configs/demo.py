"""Demo-scale configs for the end-to-end examples (examples/)."""

from .base import ModelConfig

# ~110M-param llama-style dense LM — examples/train_lm.py
# trains this for a few hundred steps on the synthetic Zipf stream.
DEMO_100M = ModelConfig(
    name="demo-100m", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=2048, vocab=32768, activation="swiglu", rope_theta=1e4,
    dtype="float32", remat="none",
)

DEMO_20M = DEMO_100M.replace(name="demo-20m", n_layers=6, d_model=384,
                             n_heads=6, n_kv_heads=2, d_ff=1024,
                             vocab=8192)
