"""Output and restart: legacy and XML VTK writers (``vtk``) and checkpoint /
resume (``checkpoint``), ports of ``sph_bvf_tpu/io``."""
