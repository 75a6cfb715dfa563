"""How each training path is set up and driven; a traffic mix names its
path by ``"path"``."""
