"""Example programs of the port: ``ernie_ctr`` (BASELINE config 5)."""
