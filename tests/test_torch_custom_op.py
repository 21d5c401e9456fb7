"""Python custom ops and autograd of the PyTorch port
(``mxnet_tpu_torch.operator``, ``mxnet_tpu_torch.autograd``) against the
JAX package's (``tests/test_custom_op.py``'s and ``tests/test_autograd.py``'s
cases) on the CPU.

The same op bodies, written once over each package's arrays, see the
same ``RandomState`` inputs.  Tolerances: the sigmoid ops 1e-6 absolute
(``exp`` differs by a few ulp between the two libraries); sums and
products of small integers are exact.  The JAX-side ops register under
``tport_*`` names, so that they never replace ``tests/test_custom_op.py``'s
own ``t_*`` ops in a shared worker.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu_torch import autograd, nd, operator  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6


# --------------------------------------------------------- the port's ops
@operator.register("t_sigmoid")
class SigmoidProp(operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=True)

    def create_operator(self, ctx, shapes, dtypes):
        return SigmoidOp()


class SigmoidOp(operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        y = 1.0 / (1.0 + torch.exp(-in_data[0]))
        self.assign(out_data[0], req[0], y)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0]
        self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))


@operator.register("t_addn")
class AddNProp(operator.CustomOpProp):
    def list_arguments(self):
        return ["a", "b"]

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def create_operator(self, ctx, shapes, dtypes):
        return AddNOp()


class AddNOp(operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] + in_data[1])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0])
        self.assign(in_grad[1], req[0], out_grad[0])


# ---------------------------------------------------- the reference's ops
@mx.operator.register("tport_sigmoid")
class JSigmoidProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return JSigmoidOp()


class JSigmoidOp(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0],
                    1.0 / (1.0 + mx.np.exp(-in_data[0])))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0]
        self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))


@mx.operator.register("tport_addn")
class JAddNProp(mx.operator.CustomOpProp):
    def list_arguments(self):
        return ["a", "b"]

    def create_operator(self, ctx, shapes, dtypes):
        return JAddNOp()


class JAddNOp(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] + in_data[1])

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], out_grad[0])
        self.assign(in_grad[1], req[0], out_grad[0])


# ------------------------------------------------------------ custom ops
@pytest.mark.parametrize("shape", [(1, 3), (4, 8), (3, 5, 7)])
def test_custom_sigmoid_forward_backward_matches_reference(shape):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = mx.nd.Custom(jx, op_type="tport_sigmoid")
    jy.backward(mx.np.array(g))
    tx = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        ty = nd.Custom(tx, op_type="t_sigmoid")
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), rtol=0,
                               atol=TOL)


def test_custom_forward_backward_reference_case():
    """``tests/test_custom_op.py::test_custom_forward_backward``."""
    x = torch.tensor([[-1.0, 0.0, 2.0]], requires_grad=True)
    with autograd.record():
        y = nd.Custom(x, op_type="t_sigmoid")
        s = y.sum()
    s.backward()
    ref = 1 / (1 + np.exp(-x.detach().numpy()))
    np.testing.assert_allclose(y.detach().numpy(), ref, atol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), ref * (1 - ref), atol=TOL)


def test_custom_multi_input_matches_reference():
    rs = np.random.RandomState(1)
    a = rs.randint(-50, 50, (2, 2)).astype(np.float32)
    b = rs.randint(-50, 50, (2, 2)).astype(np.float32)
    ja, jb = mx.np.array(a), mx.np.array(b)
    ja.attach_grad()
    jb.attach_grad()
    with mx.autograd.record():
        jo = mx.nd.Custom(ja, jb, op_type="tport_addn")
        jo.sum().backward()
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    with autograd.record():
        to = nd.Custom(ta, tb, op_type="t_addn")
        to.sum().backward()
    np.testing.assert_array_equal(to.detach().numpy(), jo.asnumpy())
    np.testing.assert_array_equal(ta.grad.numpy(), ja.grad.asnumpy())
    np.testing.assert_array_equal(tb.grad.numpy(), jb.grad.asnumpy())
    np.testing.assert_array_equal(ta.grad.numpy(), 1.0)


def test_custom_errors():
    with pytest.raises(KeyError):
        nd.Custom(torch.zeros(1), op_type="nope")
    with pytest.raises(ValueError, match="expects 1 inputs"):
        nd.Custom(torch.zeros(1), torch.zeros(1), op_type="t_sigmoid")
    with pytest.raises(ValueError, match="requires op_type"):
        nd.Custom(torch.zeros(1))
    with pytest.raises(TypeError, match="CustomOpProp subclass"):
        operator.register("t_bad")(object)
    assert {"t_sigmoid", "t_addn"} <= set(operator.get_registry())


def test_assign_requests_match_reference():
    for req in ("write", "add", "null"):
        jd = mx.np.array(np.ones((3,), np.float32))
        mx.operator.CustomOp.assign(jd, req, mx.np.array(
            np.full((3,), 2.0, np.float32)))
        td = torch.ones(3)
        operator.CustomOp.assign(td, req, torch.full((3,), 2.0))
        np.testing.assert_array_equal(td.numpy(), jd.asnumpy())
    with pytest.raises(ValueError, match="unknown req"):
        operator.CustomOp.assign(torch.ones(3), "bogus", torch.ones(3))


def test_custom_op_body_sees_the_tensors_device_and_train_flag():
    seen = {}

    @operator.register("t_probe")
    class ProbeProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            seen["ctx"], seen["shapes"], seen["dtypes"] = ctx, shapes, dtypes
            return ProbeOp()

    class ProbeOp(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen["is_train"] = is_train
            seen["out_device"] = out_data[0].device
            self.assign(out_data[0], req[0], in_data[0] * 2)

    out = nd.Custom(torch.ones(2, 3, dtype=torch.float64), op_type="t_probe")
    assert seen["ctx"] == torch.device("cpu")
    assert seen["shapes"] == [[2, 3]] and seen["dtypes"] == [torch.float64]
    # the body runs paused, as the reference's Function does
    assert seen["is_train"] is False
    assert seen["out_device"] == torch.device("cpu")
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy(), 2.0)


# --------------------------------------------------------------- autograd
def test_is_recording_training_flags_match_reference():
    ja, ta = mx.autograd, autograd
    seen = []
    for ag in (ja, ta):
        flags = [ag.is_recording(), ag.is_training()]
        with ag.record():
            flags += [ag.is_recording(), ag.is_training()]
            with ag.pause():
                flags += [ag.is_recording(), ag.is_training()]
            flags += [ag.is_recording()]
        with ag.record(train_mode=False):
            flags += [ag.is_training()]
        with ag.train_mode():
            flags += [ag.is_training(), ag.is_recording()]
        with ag.predict_mode():
            flags += [ag.is_training()]
        flags += [ag.is_recording(), ag.is_training()]
        seen.append(flags)
    assert seen[0] == seen[1]
    assert seen[1] == [False, False, True, True, False, False, True, False,
                       True, False, False, False, False]


def test_record_and_pause_set_grad_mode():
    with autograd.record():
        assert torch.is_grad_enabled()
        with autograd.pause():
            assert not torch.is_grad_enabled()
        assert torch.is_grad_enabled()
    assert torch.is_grad_enabled()      # torch's default, restored


def test_flags_are_thread_local():
    import threading
    out = {}
    with autograd.record():
        t = threading.Thread(
            target=lambda: out.update(rec=autograd.is_recording()))
        t.start()
        t.join()
        assert autograd.is_recording()
    assert out["rec"] is False


def _both(fn_j, fn_t, x):
    jx = mx.np.array(x)
    jx.attach_grad()
    tx = torch.from_numpy(x.copy())
    autograd.mark_variables([tx])
    fn_j(jx)
    fn_t(tx)
    return jx.grad.asnumpy(), tx.grad.numpy()


def test_basic_chain_and_head_grads_match_reference():
    x = np.array([0.5, 1.0, 2.0], np.float32)

    def chain_j(v):
        with mx.autograd.record():
            y = mx.np.exp(v)
            z = (y * y + y).sum()
        z.backward()

    def chain_t(v):
        with autograd.record():
            y = torch.exp(v)
            z = (y * y + y).sum()
        autograd.backward(z)

    j, t = _both(chain_j, chain_t, x)
    np.testing.assert_allclose(t, j, rtol=1e-6)

    def head_j(v):
        with mx.autograd.record():
            y = v * v
        y.backward(mx.np.array([1., 10., 100.]))

    def head_t(v):
        with autograd.record():
            y = v * v
        autograd.backward(y, torch.tensor([1., 10., 100.]))

    j, t = _both(head_j, head_t, x)
    np.testing.assert_array_equal(t, j)


def test_grad_req_write_add_match_reference():
    for req in ("write", "add"):
        res = []
        for pkg in ("jax", "torch"):
            if pkg == "jax":
                x = mx.np.array([1., 2.])
                x.attach_grad(grad_req=req)
                for _ in range(3):
                    with mx.autograd.record():
                        y = (x * x).sum()
                    y.backward()
                res.append(x.grad.asnumpy())
            else:
                x = torch.tensor([1., 2.])
                autograd.mark_variables([x], grad_reqs=req)
                for _ in range(3):
                    with autograd.record():
                        y = (x * x).sum()
                    y.backward()
                res.append(x.grad.numpy())
        np.testing.assert_array_equal(res[1], res[0])
    x = torch.tensor([1., 2.])
    autograd.mark_variables([x], grad_reqs="null")
    assert not x.requires_grad
    with pytest.raises(ValueError, match="unknown grad_req"):
        autograd.mark_variables([x], grad_reqs="sometimes")


def test_pause_multi_head_and_mark_variables_match_reference():
    x = torch.tensor([1., 2.])
    autograd.mark_variables([x])
    with autograd.record():
        y = x * 2
        with autograd.pause():
            z = x * 100
        w = (y + z.detach()).sum()
    w.backward()
    np.testing.assert_array_equal(x.grad.numpy(), [2., 2.])

    x = torch.tensor([1., 2.])
    autograd.mark_variables([x])
    with autograd.record():
        a = x * 2
        b = x * 3
    autograd.backward([a.sum(), b.sum()])
    np.testing.assert_array_equal(x.grad.numpy(), [5., 5.])

    x = torch.tensor([1., 2.])
    autograd.mark_variables([x], [torch.zeros(2)])
    with autograd.record():
        y = (x ** 3).sum()
    y.backward()
    np.testing.assert_array_equal(x.grad.numpy(), [3., 12.])


def test_grad_function_matches_reference():
    jx = mx.np.array([2.0])
    jx.attach_grad()
    with mx.autograd.record():
        jy = jx * jx * jx
    jg = mx.autograd.grad(jy, jx)
    tx = torch.tensor([2.0])
    autograd.mark_variables([tx])
    with autograd.record():
        ty = tx * tx * tx
    tg = autograd.grad(ty, [tx])
    np.testing.assert_array_equal(tg[0].numpy(), jg[0].asnumpy())
    assert tx.grad is None          # grad() leaves .grad alone
    u = torch.tensor([1.0], requires_grad=True)
    with autograd.record():
        ty = tx * 3
    assert autograd.grad(ty, [tx, u])[1].item() == 0.0


@pytest.mark.parametrize("shape", [(2,), (4, 8)])
def test_custom_function_save_for_backward_matches_reference(shape):
    class JSigmoid(mx.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + mx.np.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self._saved
            return dy * y * (1 - y)

    class TSigmoid(autograd.Function):
        def forward(self, x):
            y = 1 / (1 + torch.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self._saved
            return dy * y * (1 - y)

    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    jx = mx.np.array(x)
    jx.attach_grad()
    with mx.autograd.record():
        jy = JSigmoid()(jx)
    jy.backward()
    tx = torch.from_numpy(x).requires_grad_()
    with autograd.record():
        ty = TSigmoid()(tx)
    ty.backward(torch.ones(shape))
    np.testing.assert_allclose(ty.detach().numpy(), jy.asnumpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.asnumpy(), rtol=0,
                               atol=TOL)


def test_function_with_two_outputs_and_inputs():
    class MulAdd(autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + b

        def backward(self, g_prod, g_sum):
            a, b = self._saved
            return g_prod * b + g_sum, g_prod * a + g_sum

    a = torch.tensor([1., 2.], requires_grad=True)
    b = torch.tensor([3., 5.], requires_grad=True)
    with autograd.record():
        p, s = MulAdd()(a, b)
        (p.sum() + 2 * s.sum()).backward()
    np.testing.assert_array_equal(a.grad.numpy(), [5., 7.])
    np.testing.assert_array_equal(b.grad.numpy(), [3., 4.])
