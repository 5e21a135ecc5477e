"""Tiny sizes for the benchmark's CPU tests (``benchmark/tests``) that
``tests/conftest.py``'s ``TINY_TRAFFIC`` does not hold: the ``serve_vocoder``
driver's mixes, shrunk as ``serve``'s are, since it runs ``serve``'s loop,
churn and check.  Each mix is shrunk by its driver's entry, so without one
every tiny checkout fails.  The entry is added as that conftest registers;
folding it into the table itself makes this file go."""

SHRUNK_LIKE = {"serve_vocoder": "serve"}    # driver -> the entry it takes


def pytest_plugin_registered(plugin, manager):
    table = getattr(plugin, "TINY_TRAFFIC", None)
    if isinstance(table, dict):
        for driver, like in SHRUNK_LIKE.items():
            if like in table:
                table.setdefault(driver, table[like])
