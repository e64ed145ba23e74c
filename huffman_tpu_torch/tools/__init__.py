"""Measurement tools of the port, run as modules (on the card unless
``--device cpu`` is given, where a tool has the flag):

    python3 -m huffman_tpu_torch.tools.hist_experiments [n_mib]
    python3 -m huffman_tpu_torch.tools.run_benchmarks [--size BYTES] ...
    python3 -m huffman_tpu_torch.tools.bench_streaming [--fast] [--out FILE]
    python3 -m huffman_tpu_torch.tools.bench_small [--sizes ...] [--reps N] [--out FILE]
    python3 -m huffman_tpu_torch.tools.probe_k [--ks ...] [--out FILE]
    python3 -m huffman_tpu_torch.tools.probe_encode_stages [n_mib] [--out FILE]
    python3 -m huffman_tpu_torch.tools.probe_batched [--bs ...] [--out FILE]
"""
