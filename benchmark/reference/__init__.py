"""The benchmark's plain reference decoder: frozen copies of the port's
pure-NumPy frontend (``frontend.py``), DSP oracle (``oracle.py``) and
tables (``tables.py``, ``_data/tables.npz``), bit-exact with the
reference C decoder, and ``decode.py``, which decodes what a cell fed
its watched slots.  Nothing here imports the program, JAX or the JAX
package."""
