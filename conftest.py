"""Tiny sizes for the benchmark's CPU tests (``benchmark/tests``) of the
``serve_bigvgan`` mixes, which ``benchmark/tests/conftest.py``'s
``TINY_TRAFFIC`` does not hold: shrunk as ``serve``'s are, since
``drivers/serve_bigvgan.py`` runs ``serve``'s loop, churn and check.
Every tiny checkout shrinks each mix by its entry, so without one each of
those tests fails; the entry is added as that conftest registers
(``benchmark/conftest.py`` does the same for ``serve_vocoder``).  Folding
both into the table makes this file go.  Nothing here touches the other
tests."""

SHRUNK_LIKE = {"serve_bigvgan": "serve"}    # driver -> the entry it takes


def pytest_plugin_registered(plugin, manager):
    table = getattr(plugin, "TINY_TRAFFIC", None)
    if isinstance(table, dict):
        for driver, like in SHRUNK_LIKE.items():
            if like in table:
                table.setdefault(driver, table[like])
