"""Serving on PyTorch: prefill + greedy decode on a reduced qwen3 (qk-norm
GQA).

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    sys.argv = [sys.argv[0], "--arch", "qwen3-14b", "--smoke",
                "--batch", "2", "--prompt-len", "32", "--gen", "12"] + sys.argv[1:]
    serve.main()
