"""Example scripts of the PyTorch port, run as modules:

    python -m morfem_tpu_torch.examples.serve [--cpu]
    python -m morfem_tpu_torch.examples.waveguide_sweep [--cpu]
    python -m morfem_tpu_torch.examples.basis_size_study [--cpu]
    python -m morfem_tpu_torch.examples.complex_serve [--cpu]

Each runs on the CUDA device unless ``--cpu`` is given.
"""
