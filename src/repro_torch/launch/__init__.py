"""Entry points above the plan API: ``serve_fft`` (the transform-serving
layer), ``mesh`` (device meshes and multi-process launch for the
distributed pipeline and the trainer) and ``dryrun`` / ``roofline`` (every
cell traced on a fake production mesh).  Importing this package builds no
kernel, touches no CUDA state and creates no process group."""

from repro_torch.launch.mesh import (host_major_devices, init_multihost,
                                     init_multihost_from_env, make_fft_mesh,
                                     make_local_mesh, make_pfft3_mesh,
                                     make_production_mesh,
                                     mesh_host_shape, register_emulated_hosts)

__all__ = ["make_production_mesh", "make_local_mesh", "make_fft_mesh",
           "make_pfft3_mesh", "mesh_host_shape", "register_emulated_hosts",
           "host_major_devices", "init_multihost", "init_multihost_from_env"]
