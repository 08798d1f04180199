"""Launchers of the model zoo: the serving driver (`serve.py`) and the
training driver (`train.py`)."""
