"""PyTorch + CUDA port of HRBF-Fusion: the dense SLAM step, the sparse
keyframe backend with loop closing, the full system that joins them
(``pipeline.full_slam.FullSLAM``), the landmark-sharded bundle
adjustment over a mesh of shards, in one process or several, and the
dense step with the surfel map's rows and the images' rows split over a
mesh (``parallel/``).

A second package beside ``hrbffusion3d_tpu`` (the JAX reference, which it
is held against by the ``tests/test_torch_*.py`` parity tests).  The layout
mirrors the JAX package module for module (``core/``, ``ops/``, ``map/``,
``tracking/``, ``pipeline/``, ``eval/``, ``backend/``, ``parallel/``) and
keeps its public layouts: (H, W, C) images, the packed (N, 24) surfel rows, and
256-bit descriptors as eight 32-bit words (``int64`` on the device,
``uint32`` in numpy).

Conventions:
  - plain functions on tensors and ``NamedTuple`` results with the JAX
    package's field names;
  - the device comes from the input tensors; a function with no input
    tensor (``eval.synth.default_room``, ``core.camera.pixel_grid``,
    ``ops.patches.window_offsets``, ``backend.keyframes.SparseBackend``,
    ``pipeline.full_slam.FullSLAM``)
    makes its tensors on the CUDA card unless its ``device`` argument
    names another (the CPU tests pass ``"cpu"``), and raises when there
    is no card;
  - nothing on this path needs a gradient, so there is no
    ``torch.autograd.Function``; the one random draw, the Kinect sensor
    noise of ``eval.synth``, takes an explicit ``torch.Generator``;
  - four hand-written kernels, CUDA C++ for sm_90a: the ray cast
    (``ops/kernels.raycast_core``, ``csrc/raycast.cu``) and the bilateral
    filter, PCA normals and curvature sums (``ops/preprocess``,
    ``csrc/preprocess.cu``) run for CUDA tensors; a CPU tensor takes each
    one's plain PyTorch version.  The tensor's device decides, and a CUDA
    tensor gets the kernel or an error.

The package imports ``torch`` and never ``jax``, nor any module of the JAX
package: it keeps its own copies of ``config``, ``eval.ate``,
``io.traj``, the BRIEF pattern and the backend's numpy code.
"""
