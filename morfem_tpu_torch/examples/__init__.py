"""Example scripts of the PyTorch port, run as modules:

    python -m morfem_tpu_torch.examples.serve [--cpu]
    python -m morfem_tpu_torch.examples.waveguide_sweep [--cpu]
    python -m morfem_tpu_torch.examples.basis_size_study [--cpu]
    python -m morfem_tpu_torch.examples.complex_serve [--cpu]
    python -m morfem_tpu_torch.examples.large_n_sweep [--cpu] [--sparse]
    python -m morfem_tpu_torch.examples.banded_direct_greedy [--cpu]
    python -m morfem_tpu_torch.examples.general_sparse_mor [--cpu]
    python -m morfem_tpu_torch.examples.random_matrix_experiment [--cpu]
    python -m morfem_tpu_torch.examples.multi_geometry [--cpu] [--ranks N]
    python -m morfem_tpu_torch.examples.tp_dense_solve [--cpu] [--ranks N]

Each runs on the CUDA device unless ``--cpu`` is given; the last two
spawn ranks (one per card over NCCL by default, gloo CPU ranks under
``--cpu``).
"""
