"""Every public name a subpackage of the JAX package exports, the
port's counterpart exports too.

A package's public names are the ones its ``__init__.py`` binds: the
names of its ``from ... import`` statements and its ``__all__``.  They
are read from the reference's source, so what else a test process has
imported cannot change the list.  The only names the port may lack are
on the waiting list below, each with the ROADMAP item that ports it;
since the ensemble and fault plane came over, the list is empty.
"""

import ast
import importlib
import os

import pytest

import zkstream_tpu

#: Reference names whose modules the port has not reached yet, with the
#: ROADMAP queue item that ports them (none are left).
WAITING: dict = {}

SUBPACKAGES = ['', 'protocol', 'ops', 'parallel', 'io', 'utils', 'server',
               'analysis']


def _public_names(init_path: str) -> set:
    """The names an ``__init__.py`` exports: every name bound by its
    ``from ... import`` statements plus its ``__all__``, dunders
    excepted."""
    tree = ast.parse(open(init_path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == '__all__'
                for t in node.targets):
            names.update(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith('__')}


def _init(pkg: str) -> str:
    root = os.path.dirname(zkstream_tpu.__file__)
    return os.path.join(root, pkg, '__init__.py')


@pytest.mark.parametrize('pkg', SUBPACKAGES)
def test_port_exports_every_reference_name(pkg):
    want = _public_names(_init(pkg))
    assert want, 'no public names read from the reference %r' % (pkg,)
    port = importlib.import_module(
        'zkstream_tpu_torch' + ('.' + pkg if pkg else ''))
    waiting = WAITING.get(pkg, {})
    missing = sorted(n for n in want - set(waiting)
                     if not hasattr(port, n))
    assert not missing, 'zkstream_tpu_torch.%s lacks %s' % (pkg, missing)
    # the waiting list names only what the reference really exports,
    # and nothing the port already has
    assert set(waiting) <= want
    assert not [n for n in waiting if hasattr(port, n)]


@pytest.mark.parametrize('pkg', ['ops', 'parallel', 'analysis'])
def test_port_all_lists_what_it_binds(pkg):
    """Where the port has an ``__all__``, it names bound objects, and
    covers the reference's ``__all__``."""
    port = importlib.import_module('zkstream_tpu_torch.' + pkg)
    assert all(hasattr(port, n) for n in port.__all__)
    tree = ast.parse(open(_init(pkg)).read())
    ref_all = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign) and any(
                       isinstance(t, ast.Name) and t.id == '__all__'
                       for t in n.targets))
    assert set(ref_all) <= set(port.__all__)
