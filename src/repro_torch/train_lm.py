"""End-to-end training driver: a reduced llama-style model scaled up (d =
256, 8 layers, vocab 128), 200 steps on the synthetic pipeline, with
checkpoint/resume; the port of ``examples/train_lm.py``, with its own
checkpoint directory. It runs on the card; arguments after the script's
name override its defaults (``--device cpu``, ``--steps 20``).

    PYTHONPATH=src python -m repro_torch.train_lm
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu --steps 20
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt_example")
ARGS = ["--arch", "llama3p2_1b", "--reduced", "--scale", "4",
        "--steps", "200", "--batch", "16", "--seq", "128",
        "--ckpt-dir", CKPT_DIR, "--log-every", "20"]

if __name__ == "__main__":
    # the loss should drop markedly over the 200 steps
    main(ARGS + sys.argv[1:])
