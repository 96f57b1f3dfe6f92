"""Traffic mixes: <name>.json holds a mix's parameters and names its kind;
<kind>.py is the driver that runs every mix of that kind.  A driver has
images_needed(traffic), setup(ctx) -> state (inputs and warm calls, all
set-up) and window(ctx, state, seconds, records) (the closed loop that
appends a calls.Request a call until the window has lasted `seconds`)."""
