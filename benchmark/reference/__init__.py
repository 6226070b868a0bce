"""The benchmark's plain reference decoder: frozen copies of the port's
pure-NumPy frontend (``frontend.py``), DSP oracle (``oracle.py``) and
tables (``tables.py``, ``_data/tables.npz``), bit-exact with the
reference C decoder, and ``layer3.py``, which decodes what a cell of
Layer III streams fed its watched slots (a configuration names it under
"reference").  Nothing here imports the program, torch, JAX or the JAX
package."""
