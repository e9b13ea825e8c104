"""The port's pipeline layers: read alignment, HLA typing and the typing
workflow, with the device work on an explicit device."""
