"""Launchers of the model zoo: the serving driver (`serve.py`)."""
