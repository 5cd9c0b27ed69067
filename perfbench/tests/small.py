"""Small sizes of each cell's configuration and traffic, for running the
whole of a run on the CPU with the program's plain versions.  The cells'
limits are set at their own sizes on the card; at these sizes a sound
run's numbers are compared with a faulty run's, not with the limits."""

from __future__ import annotations

from perfbench import harness

# At width 64 the configuration's initializer range gives logits too close
# together for a served token's gap to mean anything; 0.1 spreads them as
# the full width's 0.02 does.
DECODER = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
               num_key_value_heads=4, num_hidden_layers=2, vocab_size=256,
               max_position_embeddings=128, initializer_range=0.1)
# A ResNet of four blocks on 64 x 64 images diverges in its first steps at
# the recipe's learning rate 0.1; at 0.005 its three checked steps stay
# where the full-size cell's are (losses near ln of the class count).
RESNET = dict(stage_sizes=[1, 1, 1, 1], image_size=64, num_classes=10,
              optimizer=dict(name="SGD", lr=0.005, momentum=0.9,
                             weight_decay=0.0001, nesterov=False))
TRAFFIC = {
    "train_decoder": dict(batch=2, seq_len=32, pool=4, trace_seconds=0.5),
    "train_cnn": dict(batch=16, pool=4, trace_seconds=0.5),
    "serve_decoder": dict(
        slots=4, clients=4, max_seq_len=128, buckets=[16, 32, 64],
        prompt=dict(median=20, sigma=0.8, min=4, max=64),
        output=dict(median=8, sigma=0.8, min=2, max=16), requests=64,
        warm_completions=4, check_requests=2, check_tokens=20,
        trace_seconds=0.5),
}


def sizes(cell_name: str):
    """``(cfg, traffic)`` of a cell, cut to run on the CPU in seconds."""
    cell = harness.cell(cell_name)
    cfg = harness.config(cell["config"])
    cfg.update(DECODER if cfg["family"] == "decoder" else RESNET)
    traffic = harness.traffic(cell["traffic"])
    traffic.update(TRAFFIC[traffic["kind"]])
    return cfg, traffic
