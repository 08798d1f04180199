"""Launchers of the model zoo: the serving driver (`serve.py`), the
training driver (`train.py`), and the launch planning layer: the analytic
cost model with the H100's constants (`analytic.py`), the inputs and
caches as meta tensors (`specs.py`), a step's counted FLOPs and peak live
bytes on the meta device (`step_analysis.py`) and the dry run over every
arch and input shape (`dryrun.py`); across devices, the meshes and the
simulation's local-device shards (`mesh.py`) and the sharded training demo
on a (data, model) mesh (`multidevice_demo.py`)."""
