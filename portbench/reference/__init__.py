"""The plain reference the benchmark holds the port to.

Plain NumPy and PyTorch, importing nothing of the port: frozen copies of
the scene, mesh, voxelizer, source and post-processing code
(``scene.py``, ``mesh.py``, ``voxelize.py``, ``source.py``, ``ports.py``,
``nf2ff.py``, ``physics.py``), the two scenes the configurations describe
(``scenes.py``), the coefficient assembly (``build.py``), the leapfrog with
its probes, DFTs and energy check (``yee.py``) and the two jobs end to end
(``solve.py``).
"""
