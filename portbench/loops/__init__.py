"""Program-side loop modules: each calls one of the program's PnP loops on a
traffic mix's schedule."""
