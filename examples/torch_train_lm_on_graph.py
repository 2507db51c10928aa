"""End-to-end driver on PyTorch: train a reduced LM on random walks over a
quilted MAGM graph, with fault-tolerant checkpointing (the port's full
train path).

    PYTHONPATH=src python examples/torch_train_lm_on_graph.py [--steps 200] [--device cuda|cpu]

Equivalent to:  python -m repro_torch.launch.train --arch olmo-1b --smoke ...
Runs on the card unless ``--device cpu`` is given.
"""

import sys

from repro_torch.launch import train

if __name__ == "__main__":
    sys.argv = [sys.argv[0], "--arch", "olmo-1b", "--smoke",
                "--steps", "200", "--batch", "8", "--seq", "64",
                "--graph-nodes", "1024", "--lr", "1e-3"] + sys.argv[1:]
    train.main()
