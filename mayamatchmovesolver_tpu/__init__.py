"""mayamatchmovesolver_tpu — a JAX matchmove / bundle-adjustment framework.

A from-scratch re-design of the capabilities of mmSolver (mayaMatchMoveSolver)
as JAX/XLA programs that run on an NVIDIA GPU (and on the CPU for tests):
the scene evaluation engine, 3DE-compatible lens distortion,
Levenberg-Marquardt bundle adjustment with analytic (autodiff) Jacobians,
SfM bootstrap, solve strategies, marker/lens file interop and multi-device
scaling via jax.sharding.

Capability map (reference file:line cites are to the mmSolver repo):
  core/    — transform / camera / reprojection math
             (ref: lib/rust/mmscenegraph/src/math/*.rs)
  scene/   — SoA attribute block + flattened scene evaluation
             (ref: lib/rust/mmscenegraph/src/attr/datablock.rs, scene/flat.rs)
  models/  — 3DEqualizer-compatible lens distortion model families
             (ref: lib/cppbind/mmlens)
  ops/     — image-side programs (ST-map generation, warping, lens deform)
  solver/  — residuals, robust loss, box constraints, LM core, Schur/CG,
             solve strategies (ref: src/mmSolver/adjust)
  sfm/     — essential matrix, triangulation, homography, resection,
             vanishing-point calibration (ref: src/mmSolver/sfm, calibrate)
  parallel/— device-mesh sharded bundle adjustment (new; reference is
             single-host single-threaded)
  io/      — marker formats (uvtrack/3DE/PFTrack/rz2), Nuke lens files, EXR
             (ref: python/mmSolver/utils/loadmarker, lib/rust/mmimage)
  utils/   — smoothing, kalman, config, logging
             (ref: python/mmSolver/utils)
  tools/   — artist-tool data capabilities: screen-space conversion,
             center-2D, reparent, scene-scale, attribute bake, marker
             ops, origin frame, ray-cast (ref: python/mmSolver/tools)
  api      — object-oriented user API (ref: python/mmSolver/_api)
"""

__version__ = "0.1.0"

from mayamatchmovesolver_tpu.utils import config as _config  # noqa: F401
