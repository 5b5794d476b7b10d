"""The benchmark's yardstick: the data generator, the plain alignment
reference and judge, and the frozen roofline count.

Nothing here imports ``sortmerna_tpu_torch``, ``sortmerna_tpu`` or
``jax``: the reference works out again everything the program derives
from the inputs it is handed.
"""
