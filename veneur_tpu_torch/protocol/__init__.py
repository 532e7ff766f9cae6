"""DogStatsD wire rendering (`render.py`). The SSF framing of the JAX
package's `protocol/wire.py` arrives with the SSF plane."""
