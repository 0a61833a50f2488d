"""Fixture kernels for the AVDB9xx twin-contract rules (the port's).

A wrapper calls its ``<name>_launch`` entry point on the ctypes library;
``<name>_reference`` is its plain version.
"""


def _library():
    return None


def good_kernel_reference(x):
    return x


def good_kernel(x):                           # registered + tested: clean
    return _library().good_kernel_launch(x)


def untested_kernel_reference(x):
    return x


def untested_kernel(x):                       # 903 fires at the registry
    return _library().untested_kernel_launch(x)


def orphan_kernel(x):                         # its TWIN is stale (registry)
    return _library().orphan_kernel_launch(x)


def helper(x):                # no launch call: not a wrapper, no finding
    return x


def rogue_kernel_reference(x):
    return x


def rogue_kernel(x):                        # EXPECT: AVDB901
    return _library().rogue_kernel_launch(x)


def decorated_rogue(x):                     # EXPECT: AVDB901
    return _library().decorated_rogue_launch(x)


# a wrapper whose launch sits deeper in its body
def partial_rogue(x, mode):                 # EXPECT: AVDB901
    if mode:
        return _library().partial_rogue_launch(x, mode)
    return x


# a wrapper that names its library's entry point through a local

def mesh_rogue(x):                          # EXPECT: AVDB901
    lib = _library()
    return lib.mesh_rogue_launch(x)
