"""Run configs of the port's CLI (``mwd-torch train --config <file>``).

One file for each config of the reference's ``configs/`` directory, with
the same values, built on the port's ``core.config.base_config`` (the
reference's files import the JAX package and ml_collections).  Each file
is a python module with ``get_config()``; ``core.config.load_config`` runs
it.
"""
