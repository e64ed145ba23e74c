"""Measurement tools of the port, run as modules:

    python3 -m huffman_tpu_torch.tools.hist_experiments [n_mib]
    python3 -m huffman_tpu_torch.tools.run_benchmarks [--size BYTES] ...
"""
