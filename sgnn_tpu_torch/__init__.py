"""SG-NN scene completion in PyTorch with hand-written CUDA kernels.

The port of ``sgnn_tpu`` (JAX/Pallas) to PyTorch on NVIDIA Hopper. Module
names mirror the JAX package so each module's counterpart is easy to find:

  config.py              SGNNConfig (a copy; tests hold it to the original)
  params.py              init_params / load_jax_params
  ops/folded.py          the folded FGrid layout and the fused sites
  ops/kernels/*.py       one wrapper per CUDA kernel, each with its plain
                         PyTorch version and a launch counter
  csrc/*.cu              the CUDA C++ kernels (sm_90a), built at first use
  ops/dense.py, ops/bn.py  the 1/8-resolution trunk's conv and BN, the
                         upsampled conv, max pool and masked row BN
  ops/coords.py, ops/sparse.py, ops/conv.py, nn/blocks.py
                         coordinate lists, SparseTensor, sparse convs
  models/folded_flow.py  GenModelFolded, the only-surface serving forward
  models/dense_flow.py   the dense trunk; GenModelDense (dense flow)
  models/sgnn.py         GenModelSparse (coordinate lists, the oracle)
  infer.py               SceneInferencer
  losses.py              training losses and the evaluation metrics
  checkpoint.py, utils/ckpt_convert.py
                         .ckpt files; reference .pth both ways
  datagen/               synthetic rooms, .sens, depth rendering and TSDF
                         fusion (host numpy and g++-built C++), chunking
  tools/                 the CLIs: test_scene, evaluate, train,
                         convert_checkpoint, make_synthetic_scenes,
                         generate_scans, make_chunks

This package imports torch and numpy only: never jax, never sgnn_tpu.
"""
